// All slot-attention refinement iterations in one kernel.
//
// Replaces the Pallas kernels `_sa_kernel_resident` / `_sa_kernel` driven
// by `sa_iterations_pallas` (the JAX package's ops/slot_attention_kernel.py:
// 134-250, 267-316, 319-416). Per item and per iteration:
//
//   q       = bf16(LN(slots) @ Wq)                    [S, D]
//   a[:, n] = softmax_s(scale * q . k_n)              [S, N]  (mask: last it)
//   num     = bf16(a) @ v,  den = sum_n a,  vsum = sum_n v
//   upd     = (num + eps * vsum) / (den + N * eps)    (the +eps renorm)
//   slots   = GRUCell(upd, slots)                     (torch parameterization)
//   slots  += MLP(LN(slots))
//
// k and v arrive in bf16; every product accumulates in f32.
//
// Design: one block of 256 threads per item, looping over iterations and,
// inside each, over tiles of 64 positions of k/v. At N = 1024, D = 192 the
// k/v of one item take 768 KB, more than shared memory, so each iteration
// streams them from device memory (L2 holds them across the two
// iterations: 12 items x 768 KB = 9 MB of the 50 MB L2). Slots, q, the
// attention tile and the num/den/vsum accumulators stay on chip (num in
// registers, the rest in shared memory); the GRU and the MLP on the
// [S <= 16, D] slots read their f32 weights from global memory (L2).
// Bound on the H100: ~2 * N * S * D * 2 flops per item-iteration against
// 2 * N * D * 2 bytes of k/v, ~S flops per byte, so the op is bound by
// bytes; with B = 12 blocks only 12 of 132 SMs work, which is what a later
// split of N across blocks would fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPad = 16;   // slots held per block (S <= 16)
constexpr int kTileN = 64;      // positions of k/v per shared-memory tile
constexpr int kMaxD = 256;
constexpr int kMaxM = 1024;
constexpr int kAcc = kSlotsPad * kMaxD / kThreads;  // num accumulators/thread
constexpr float kLnEps = 1e-5f;  // torch nn.LayerNorm default

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// y[s, :] = LN(x[s, :]) * g + beta for s < S; one warp per row.
__device__ void layer_norm_rows(const float* x, float* y, const float* g,
                                const float* beta, int S, int D, int LD) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = warp; s < S; s += kThreads / 32) {
    const float* xr = x + s * LD;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += xr[d];
    const float mu = warp_sum(sum) / D;
    float sq = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float t = xr[d] - mu;
      sq += t * t;
    }
    const float rs = rsqrtf(warp_sum(sq) / D + kLnEps);
    for (int d = lane; d < D; d += 32)
      y[s * LD + d] = (xr[d] - mu) * rs * g[d] + beta[d];
  }
}

__global__ void __launch_bounds__(kThreads)
sa_iterations_kernel(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ slots0, const float* __restrict__ wq,
    const float* __restrict__ lnq_g, const float* __restrict__ lnq_b,
    const float* __restrict__ gwi, const float* __restrict__ gbi,
    const float* __restrict__ gwh, const float* __restrict__ gbh,
    const float* __restrict__ lnm_g, const float* __restrict__ lnm_b,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ slots_out, float* __restrict__ mask,
    int N, int S, int D, int M, int iters, float eps, float scale,
    int with_mask) {
  extern __shared__ float smem[];
  const int LD = D + 1;   // f32 row stride: rows land in distinct banks
  const int KLD = D + 2;  // bf16 row stride (D even): likewise
  float* sl = smem;                    // slots            [16, LD]
  float* qa = sl + kSlotsPad * LD;     // q / new slots    [16, LD]
  float* up = qa + kSlotsPad * LD;     // LN out / updates [16, LD]
  float* hb = up + kSlotsPad * LD;     // MLP hidden       [16, M]
  float* at = hb + kSlotsPad * M;      // attention tile   [16, kTileN]
  float* den = at + kSlotsPad * kTileN;  // [16]
  float* vsum = den + kSlotsPad;         // [D]
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(vsum + D);
  __nv_bfloat16* vt = kt + kTileN * KLD;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const __nv_bfloat16* kb = k + (size_t)b * N * D;
  const __nv_bfloat16* vb = v + (size_t)b * N * D;
  const int SD = S * D;
  const int half = D / 2;

  for (int idx = tid; idx < SD; idx += kThreads)
    sl[(idx / D) * LD + idx % D] = slots0[(size_t)b * SD + idx];
  for (int d = tid; d < D; d += kThreads) vsum[d] = 0.f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const bool last = it == iters - 1;
    layer_norm_rows(sl, up, lnq_g, lnq_b, S, D, LD);
    __syncthreads();
    for (int idx = tid; idx < SD; idx += kThreads) {
      const int s = idx / D, d = idx % D;
      float acc = 0.f;
      for (int kk = 0; kk < D; ++kk) acc = fmaf(up[s * LD + kk], wq[kk * D + d], acc);
      qa[s * LD + d] = bf16_round(acc);
    }
    if (tid < kSlotsPad) den[tid] = 0.f;
    float num[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) num[i] = 0.f;
    __syncthreads();

    for (int n0 = 0; n0 < N; n0 += kTileN) {
      const int tn = min(kTileN, N - n0);
      for (int idx = tid; idx < tn * half; idx += kThreads) {
        const int r = idx / half, c2 = idx % half;
        const size_t g = (size_t)(n0 + r) * D;
        reinterpret_cast<__nv_bfloat162*>(kt + r * KLD)[c2] =
            reinterpret_cast<const __nv_bfloat162*>(kb + g)[c2];
        reinterpret_cast<__nv_bfloat162*>(vt + r * KLD)[c2] =
            reinterpret_cast<const __nv_bfloat162*>(vb + g)[c2];
      }
      __syncthreads();
      // logits; 16 consecutive threads share one position (broadcast of k)
      for (int idx = tid; idx < kSlotsPad * tn; idx += kThreads) {
        const int s = idx % kSlotsPad, j = idx / kSlotsPad;
        if (s >= S) continue;
        const float* qr = qa + s * LD;
        const __nv_bfloat16* kr = kt + j * KLD;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], __bfloat162float(kr[d]), acc);
        at[s * kTileN + j] = acc * scale;
      }
      __syncthreads();
      // softmax over the slots of each position
      for (int j = tid; j < tn; j += kThreads) {
        float mx = at[j];
        for (int s = 1; s < S; ++s) mx = fmaxf(mx, at[s * kTileN + j]);
        float sum = 0.f;
        for (int s = 0; s < S; ++s) {
          const float e = expf(at[s * kTileN + j] - mx);
          at[s * kTileN + j] = e;
          sum += e;
        }
        const float inv = 1.f / sum;
        for (int s = 0; s < S; ++s) {
          const float a = at[s * kTileN + j] * inv;
          at[s * kTileN + j] = a;
          if (last && with_mask) mask[((size_t)b * S + s) * N + n0 + j] = a;
        }
      }
      __syncthreads();
      if (tid < S) {
        float acc = 0.f;
        for (int j = 0; j < tn; ++j) acc += at[tid * kTileN + j];
        den[tid] += acc;
      }
      if (it == 0) {
        for (int d = tid; d < D; d += kThreads) {
          float acc = 0.f;
          for (int j = 0; j < tn; ++j) acc += __bfloat162float(vt[j * KLD + d]);
          vsum[d] += acc;
        }
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int idx = tid + i * kThreads;
        if (idx < SD) {
          const int s = idx / D, d = idx % D;
          float acc = num[i];
          for (int j = 0; j < tn; ++j)
            acc = fmaf(bf16_round(at[s * kTileN + j]),
                       __bfloat162float(vt[j * KLD + d]), acc);
          num[i] = acc;
        }
      }
      __syncthreads();  // the tile buffers are refilled next
    }

    // renormalized weighted mean of v
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < SD) {
        const int s = idx / D, d = idx % D;
        up[s * LD + d] = (num[i] + eps * vsum[d]) / (den[s] + N * eps);
      }
    }
    __syncthreads();
    // GRUCell (torch parameterization, gates packed r | z | n) -> qa
    for (int idx = tid; idx < SD; idx += kThreads) {
      const int s = idx / D, d = idx % D;
      float ir = gbi[d], iz = gbi[D + d], in = gbi[2 * D + d];
      float hr = gbh[d], hz = gbh[D + d], hn = gbh[2 * D + d];
      for (int kk = 0; kk < D; ++kk) {
        const float u = up[s * LD + kk], h = sl[s * LD + kk];
        const float* wi = gwi + (size_t)kk * 3 * D;
        const float* wh = gwh + (size_t)kk * 3 * D;
        ir = fmaf(u, wi[d], ir);
        iz = fmaf(u, wi[D + d], iz);
        in = fmaf(u, wi[2 * D + d], in);
        hr = fmaf(h, wh[d], hr);
        hz = fmaf(h, wh[D + d], hz);
        hn = fmaf(h, wh[2 * D + d], hn);
      }
      const float r = sigmoidf(ir + hr);
      const float z = sigmoidf(iz + hz);
      const float n = tanhf(in + r * hn);
      qa[s * LD + d] = (1.f - z) * n + z * sl[s * LD + d];
    }
    __syncthreads();
    // residual MLP: slots = new + relu(LN(new) @ w1 + b1) @ w2 + b2
    layer_norm_rows(qa, up, lnm_g, lnm_b, S, D, LD);
    __syncthreads();
    for (int idx = tid; idx < S * M; idx += kThreads) {
      const int s = idx / M, m = idx % M;
      float acc = 0.f;
      for (int kk = 0; kk < D; ++kk) acc = fmaf(up[s * LD + kk], w1[(size_t)kk * M + m], acc);
      hb[s * M + m] = fmaxf(acc + b1[m], 0.f);
    }
    __syncthreads();
    for (int idx = tid; idx < SD; idx += kThreads) {
      const int s = idx / D, d = idx % D;
      float acc = 0.f;
      for (int m = 0; m < M; ++m) acc = fmaf(hb[s * M + m], w2[(size_t)m * D + d], acc);
      sl[s * LD + d] = qa[s * LD + d] + (acc + b2[d]);
    }
    __syncthreads();
  }
  for (int idx = tid; idx < SD; idx += kThreads)
    slots_out[(size_t)b * SD + idx] = sl[(idx / D) * LD + idx % D];
}

size_t smem_bytes(int D, int M) {
  const size_t f32 = 3 * kSlotsPad * (D + 1) + kSlotsPad * M +
                     kSlotsPad * kTileN + kSlotsPad + D;
  return f32 * sizeof(float) + 2 * kTileN * (D + 2) * sizeof(__nv_bfloat16);
}

}  // namespace

extern "C" int sdt_sa_iterations_bf16(
    const void* k, const void* v, const float* slots0, const float* wq,
    const float* lnq_g, const float* lnq_b, const float* gwi, const float* gbi,
    const float* gwh, const float* gbh, const float* lnm_g,
    const float* lnm_b, const float* w1, const float* b1, const float* w2,
    const float* b2, float* slots_out, float* mask, int B, int N, int S,
    int D, int M, int iters, float eps, float scale, int with_mask,
    void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || S > kSlotsPad || D <= 0 || D > kMaxD ||
      D % 2 || M <= 0 || M > kMaxM || iters <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, M);
  cudaError_t err = cudaFuncSetAttribute(
      sa_iterations_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sa_iterations_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), slots0, wq, lnq_g, lnq_b, gwi,
      gbi, gwh, gbh, lnm_g, lnm_b, w1, b1, w2, b2, slots_out, mask, N, S, D,
      M, iters, eps, scale, with_mask);
  return (int)cudaGetLastError();
}
