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
// Keys past Nk (none here: the wrapper passes the true Nk) get weight 0.
//
// Design: one block per (query tile of 64, head, batch item), one thread
// per query row. The thread keeps its q row and its f32 accumulator in
// registers; K and V of the head stream through shared memory in tiles of
// 64 keys, and every thread reads the same key row (a broadcast). Bound on
// the H100: at the UNet's shapes (Nq <= 256, Nk <= 256, D = 32) the work is
// ~4*Nk*D flops per 4*D*4 bytes of q/out traffic, ~Nk/4 flops per byte,
// so the largest shape is bound by f32 CUDA-core throughput, the
// cross-attention (Nk = 15) by bytes. The design reads q, k and v and
// writes out once per block, keeps logits out of memory, and leaves tensor
// cores and a faster tiling to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kQTile = 64;
constexpr int kKTile = 64;

__global__ void __launch_bounds__(kQTile)
mha_clamped_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   int Nq, int Nk, int H, float scale) {
  __shared__ float ks[kKTile][kHeadDim];
  __shared__ float vs[kKTile][kHeadDim];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int HD = H * kHeadDim;
  const int qi = blockIdx.x * kQTile + threadIdx.x;
  const bool active = qi < Nq;

  float qr[kHeadDim];
  float acc[kHeadDim];
  const float* qp = q + ((size_t)b * Nq + (active ? qi : 0)) * HD +
                    h * kHeadDim;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    qr[d] = active ? qp[d] : 0.f;
    acc[d] = 0.f;
  }
  float denom = 0.f;

  const float* kb = k + (size_t)b * Nk * HD + h * kHeadDim;
  const float* vb = v + (size_t)b * Nk * HD + h * kHeadDim;
  for (int k0 = 0; k0 < Nk; k0 += kKTile) {
    const int tk = min(kKTile, Nk - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kKTile * kHeadDim; idx += blockDim.x) {
      const int r = idx / kHeadDim;
      const int c = idx % kHeadDim;
      const bool in = r < tk;
      ks[r][c] = in ? kb[(size_t)(k0 + r) * HD + c] : 0.f;
      vs[r][c] = in ? vb[(size_t)(k0 + r) * HD + c] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < tk; ++j) {
      float logit = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) logit = fmaf(qr[d], ks[j][d], logit);
      const float e = expf(fminf(logit * scale, 80.f));
      denom += e;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(e, vs[j][d], acc[d]);
    }
  }
  if (!active) return;
  const float inv = 1.f / (denom + 1e-30f);
  float* op = out + ((size_t)b * Nq + qi) * HD + h * kHeadDim;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) op[d] = acc[d] * inv;
}

}  // namespace

extern "C" int sdt_mha_f32(const float* q, const float* k, const float* v,
                           float* out, int B, int Nq, int Nk, int H, int D,
                           float scale, void* stream) {
  if (D != kHeadDim || B <= 0 || Nq <= 0 || Nk <= 0 || H <= 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Nq + kQTile - 1) / kQTile, H, B);
  mha_clamped_kernel<<<grid, kQTile, 0, (cudaStream_t)stream>>>(
      q, k, v, out, Nq, Nk, H, scale);
  return (int)cudaGetLastError();
}
