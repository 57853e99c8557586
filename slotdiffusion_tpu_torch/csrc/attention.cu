// Multi-head attention with the clamped-exp softmax, f32, head_dim 32.
//
// Replaces the Pallas kernel `_mha_kernel` driven by `fused_mha`
// (the JAX package's ops/attention_kernel.py:61-90, 119-156).
//
//   q [B, Nq, H*D], k/v [B, Nk, H*D]  (heads packed, D = 32)
//   out[b, i, h] = sum_j e_ij v_j / (sum_j e_ij + 1e-30),
//   e_ij = exp(min(scale * q_i . k_j, 80))
//
// There is no max subtraction, so the softmax needs no online rescaling:
// one pass over the keys accumulates the numerator and the denominator.
//
// Design: both products on the tensor cores, f32-accurate. A block owns
// one (batch item, head) and up to 4 warps of 16 query rows each (fewer
// when Nq is small, so no warp idles at Nq = 16). The block stages the
// head's K and V once in shared memory (up to 256 keys a pass, 16-byte
// loads, rows padded to 36 floats so every fragment read hits 32
// distinct banks; the keys are zero-padded to a multiple of 8). Each warp
// keeps its 16 q rows as TF32 A fragments, then for every 8 keys:
//   S = q k^T   mma.sync m16n8k8 TF32, 4 k-steps over D,
//   e = exp(min(scale * S, 80)), exactly 0 on a padded key,
//   O += e v    mma.sync m16n8k8 TF32, 4 n-blocks over D,
// with e going from the accumulator layout to the A layout in registers:
// the PV product takes its 8 keys in the order 0,2,4,6,1,3,5,7 (the V
// fragment reads the same order), so a thread's two accumulator columns
// are its two A columns. Every product is 3xTF32: each f32 operand is
// split into hi = tf32(a) and lo = tf32(a - hi), and a_lo b_hi + a_hi b_lo
// + a_hi b_hi is accumulated in f32 (about 21 bits of each operand; plain
// TF32 keeps 10 and misses the f32 tolerance). The row sums of e are
// taken in f32 from the unsplit e, reduced across the 4 threads of a row.
//
// Bound on the H100: 4*B*Nq*Nk*H*D f32 operations, issued as three TF32
// products each (495 TFLOP/s dense), against q, k, v and out moved once
// (3.35 TB/s). Self-attention at Nq = 256 is bound by the TF32 products,
// cross-attention (Nk = 15) and the 16- and 64-token levels by bytes.
//
// At the flagship's shapes (PERF.md): 4.9 us of TF32 products at B = 12,
// Nq = Nk = 256, 8 heads (the largest serving call), 0.5 us of bytes at
// B = 12, Nq = 16, Nk = 15, 16 heads.
//
// ptxas -v (sm_90a, CUDA 12 on the card; chip_smoke.py phase 2 prints
// it): 95 registers, 0 bytes of spill stores and loads; dynamic shared
// memory 2 * keys * 36 * 4 bytes, 73,728 at 256 keys (3 blocks an SM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kLd = kHeadDim + 4;   // padded shared row, in floats
constexpr int kMaxKeys = 256;       // keys staged per pass
constexpr int kMaxWarps = 4;        // 16 query rows each

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two small cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4],
                                           const uint32_t al[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
mha_clamped_tc_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int Nq, int Nk, int H, int tile, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [tile][kLd]
  float* vs = smem + tile * kLd;  // [tile][kLd]
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * kHeadDim;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // MMA fragment coordinates
  const int row0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16;
  const bool active = row0 < Nq;  // uniform over the warp

  // q rows row0 + g (+8) as A fragments of the 4 k-steps over D: element
  // i is row g + 8 (i & 1), column 8 ks + t4 + 4 (i >> 1)
  uint32_t qh[4][4], ql[4][4];
  const float* qb = q + (size_t)b * Nq * HD + h * kHeadDim;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const float x = row < Nq ?
          qb[(size_t)row * HD + 8 * s + t4 + 4 * (i >> 1)] : 0.f;
      split(x, qh[s][i], ql[s][i]);
    }

  float o[4][4];  // [n-block of D][accumulator element]
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // this thread's part of rows g, g + 8

  const float* kb = k + (size_t)b * Nk * HD + h * kHeadDim;
  const float* vb = v + (size_t)b * Nk * HD + h * kHeadDim;
  for (int j0 = 0; j0 < Nk; j0 += tile) {
    const int nkeys = min(tile, Nk - j0);
    const int npad = (nkeys + 7) / 8 * 8;
    __syncthreads();  // the previous pass's K/V are no longer read
    for (int i = threadIdx.x; i < npad * (kHeadDim / 4); i += blockDim.x) {
      const int r = i / (kHeadDim / 4), c = 4 * (i % (kHeadDim / 4));
      float4 kr = make_float4(0.f, 0.f, 0.f, 0.f), vr = kr;
      if (r < nkeys) {
        kr = *reinterpret_cast<const float4*>(kb + (size_t)(j0 + r) * HD + c);
        vr = *reinterpret_cast<const float4*>(vb + (size_t)(j0 + r) * HD + c);
      }
      *reinterpret_cast<float4*>(ks + r * kLd + c) = kr;
      *reinterpret_cast<float4*>(vs + r * kLd + c) = vr;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < npad; j += 8) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float* kr = ks + (j + g) * kLd + 8 * d + t4;  // B = K^T
        mma_3xtf32(s, qh[d], ql[d], kr[0], kr[4]);
      }
      // accumulator element i: row g + 8 (i >> 1), key j + 2 t4 + (i & 1)
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = j + 2 * t4 + (i & 1) < nkeys ?
            expf(fminf(s[i] * scale, 80.f)) : 0.f;
      l0 += e[0] + e[1];
      l1 += e[2] + e[3];
      // A fragment of e with the keys in the order 0,2,4,6,1,3,5,7
      uint32_t ph[4], pl[4];
      split(e[0], ph[0], pl[0]);
      split(e[2], ph[1], pl[1]);
      split(e[1], ph[2], pl[2]);
      split(e[3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* vr = vs + (j + 2 * t4) * kLd + 8 * n + g;
        mma_3xtf32(o[n], ph, pl, vr[0], vr[kLd]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, m);
    l1 += __shfl_xor_sync(0xffffffffu, l1, m);
  }
  const float inv0 = 1.f / (l0 + 1e-30f), inv1 = 1.f / (l1 + 1e-30f);
  float* ob = out + (size_t)b * Nq * HD + h * kHeadDim + 2 * t4;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (r0 < Nq)
      *reinterpret_cast<float2*>(ob + (size_t)r0 * HD + 8 * n) =
          make_float2(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < Nq)
      *reinterpret_cast<float2*>(ob + (size_t)r1 * HD + 8 * n) =
          make_float2(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace

// q, k, v, out: 16-byte-aligned contiguous f32 (the wrapper checks)
extern "C" int sdt_mha_f32(const float* q, const float* k, const float* v,
                           float* out, int B, int Nq, int Nk, int H, int D,
                           float scale, void* stream) {
  if (D != kHeadDim || B <= 0 || Nq <= 0 || Nk <= 0 || H <= 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int warps = min(kMaxWarps, (Nq + 15) / 16);
  const int tile = min(kMaxKeys, (Nk + 7) / 8 * 8);
  const int smem = 2 * tile * kLd * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mha_clamped_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * kMaxKeys * kLd * (int)sizeof(float));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Nq + 16 * warps - 1) / (16 * warps), H, B);
  mha_clamped_tc_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      q, k, v, out, Nq, Nk, H, tile, scale);
  return (int)cudaGetLastError();
}
