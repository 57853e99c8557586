// 3x3 stride-1 SAME convolution (no bias) by Winograd F(2x2, 3x3), bf16.
//
// Replaces the Pallas kernel `_wino_kernel` driven by `_wino_call` /
// `winograd_conv3x3` (the JAX package's ops/winograd_conv.py:78-150,
// 180-198, 209-232).
//
//   x [B, H, W, C] bf16 (NHWC), U^T [16, Fp, Cp] bf16 (U = G g G^T), y [B,
//   H, W, F] bf16; per 4x4 input tile d (stride 2, zero padding 1):
//     V_uv = (B^T d B)_uv                    in f32, rounded to bf16
//     M_uv = sum_c V_uv[c] * U_uv[c, :]      bf16 operands, f32 sums
//     y    = A^T M A                         2x2 outputs, f32, then bf16
//
// B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]],
// A^T = [[1,1,1,0],[0,1,-1,-1]]. The rounding points are the JAX kernel's:
// V and U in bf16, every product exact in f32, every sum in f32.
//
// Design (three kernels, one stream):
// - weights: w [3, 3, C, F] f32 -> U^T [16, Fp, Cp] bf16, zero-padded to
//   whole blocks, in the plain version's f32 order; a call of its own
//   (`sdt_winograd_weights_bf16`), so a caller that keeps U pays it once.
// - V pass: x -> V [16, Tp, Cp] bf16, built once per tile and channel
//   (four channels a thread with 8-byte loads and stores, two where C is
//   not a multiple of 4; rows of B^T first as the JAX kernel), zero on
//   the padded tiles and channels.
// - products: 16 GEMMs [Tp, Cp] x [Cp, Fp] with the inverse transform
//   fused. A block owns 128 tiles x 64 output channels and walks the flat
//   sequence (uv, 64-channel chunk) through a ring of 5 shared-memory
//   stages (27 KB each) filled by cp.async (16 bytes a copy), so the
//   loads of the next four chunks (110 KB in flight an SM, enough to
//   cover L2 latency) overlap the MMAs of this one. 8 warps of 32 tiles x
//   32 channels run bf16 mma.sync m16n8k16 (ldmatrix fragments; shared
//   rows padded to 72 values, conflict-free) into one M_uv accumulator,
//   folded
//   into four y accumulators (A^T M A is linear in M) when the uv
//   changes: 5 f32 registers per output pair instead of 16, so a block
//   holds 128 x 64 outputs and each V chunk feeds 64 channels. Levels
//   with fewer blocks than SMs split the (uv, chunk) sequence over
//   gridDim.z (split-K): each split writes its partial y to its own plane
//   of an f32 scratch [splits, B*H*W*F], and a last pass sums the planes
//   in order and rounds to bf16 (deterministic, no atomics).
//
// Bound on the H100 at the flagship UNet's four ResBlock conv shapes
// (B = 32; 32x32 C=F=128, 16x16 256, 8x8 384, 4x4 512), for the
// convolution on U: the 16 products are 8*B*H*W*C*F operations on bf16
// operands (4.3, 4.3, 2.4, 1.1 GFLOP: 4.3, 4.3, 2.4, 1.1 us at 989
// TFLOP/s) against x, U and y moved once (17.3, 10.5, 7.9, 9.4 MB: 5.2,
// 3.1, 2.4, 2.8 us at 3.35 TB/s), so bytes set the bound at levels 0 and
// 3 and operations at levels 1 and 2 (13.5 us summed). What holds this
// design back from it (measured on the card, PERF.md): the V pass writes
// V, 4x the size of x, and the products read it back F/64 times; each
// block folds M_uv into y on the CUDA cores (36 FMAs an output pair per
// pass over the 16 uv, as many instructions as its MMAs at level 0);
// mma.sync with one 8-warp block an SM reaches a fraction of wgmma's
// rate; the split levels add a sum pass.
//
// ptxas -v (sm_90a, CUDA 12 on the card; chip_smoke.py phase 2 prints
// it): products kernel 228 registers, 0 bytes of spill stores and loads,
// 138,240 bytes of dynamic shared memory; V pass (4 channels) 54
// registers; weights kernel 48 registers and 34,816 bytes of static
// shared memory; no kernel spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMt = 128;            // tiles per block
constexpr int kNt = 64;             // output channels per block
constexpr int kKc = 64;             // input channels per stage
constexpr int kLd = kKc + 8;        // padded shared row, in bf16 values
constexpr int kStages = 5;          // cp.async ring
constexpr int kWarpsN = 2;          // warps along F (4 along tiles)
constexpr int kThreads = 32 * 4 * kWarpsN;
constexpr int kNi = kNt / kWarpsN / 8;  // n8 blocks of a warp
constexpr int kNj = kNi / 2;            // ldmatrix.x4 loads of B a k-step
constexpr int kStageElems = (kMt + kNt) * kLd;
constexpr int kSmemBytes = kStages * kStageElems * 2;
constexpr int kOutLd = kNt + 4;     // epilogue row, in floats
static_assert(2 * kMt * kOutLd * 4 + kMt * 9 <= kSmemBytes,
              "the epilogue reuses the stages");

// (B^T r)[u] over four values, in the JAX kernel's order of terms
__device__ __forceinline__ float bt_row(int u, const float r[4]) {
  switch (u) {
    case 0: return r[0] - r[2];
    case 1: return r[1] + r[2];
    case 2: return r[2] - r[1];
    default: return r[1] - r[3];
  }
}

// A^T[a][u]
__device__ __forceinline__ float at(int a, int u) {
  if (a == 0) return u < 3 ? 1.f : 0.f;
  return u == 0 ? 0.f : (u == 1 ? 1.f : -1.f);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// VEC bf16 values moved as one word (VEC = 2: 4 bytes, 4: 8 bytes)
template <int VEC>
struct Vec;
template <>
struct Vec<2> { using T = uint32_t; };
template <>
struct Vec<4> { using T = uint2; };

// V [16, Tp, Cp] from x: one thread per (tile, VEC channels), C a
// multiple of VEC
template <int VEC>
__global__ void __launch_bounds__(256)
winograd_input_kernel(const __nv_bfloat16* __restrict__ x,
                      __nv_bfloat16* __restrict__ v, int H, int W, int C,
                      int T, int Tp, int Cp, int nth, int ntw) {
  using Word = typename Vec<VEC>::T;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int groups = Cp / VEC;
  if (idx >= (int64_t)Tp * groups) return;
  const int t = (int)(idx / groups);
  const int c = VEC * (int)(idx % groups);
  Word d[4][4];  // the tile's 16 taps, VEC channels each, zero outside
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) d[r][s] = Word{};
  if (t < T && c < C) {  // C is a multiple of VEC: all channels or none
    const int tiles_per_img = nth * ntw;
    const int n = t / tiles_per_img, rem = t % tiles_per_img;
    const int row0 = 2 * (rem / ntw) - 1, col0 = 2 * (rem % ntw) - 1;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (row0 + r >= 0 && row0 + r < H && col0 + s >= 0 && col0 + s < W)
          d[r][s] = *reinterpret_cast<const Word*>(
              x + (((int64_t)n * H + row0 + r) * W + col0 + s) * C + c);
  }
  Word out[16];
#pragma unroll
  for (int p = 0; p < VEC / 2; ++p) {  // one channel pair at a time
    float2 f[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        f[r][s] = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(&d[r][s])[p]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float gx[4], gy[4];  // row transform first, as the JAX kernel
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float cx[4] = {f[0][s].x, f[1][s].x, f[2][s].x, f[3][s].x};
        const float cy[4] = {f[0][s].y, f[1][s].y, f[2][s].y, f[3][s].y};
        gx[s] = bt_row(u, cx);
        gy[s] = bt_row(u, cy);
      }
#pragma unroll
      for (int vv = 0; vv < 4; ++vv)
        reinterpret_cast<__nv_bfloat162*>(&out[4 * u + vv])[p] =
            __floats2bfloat162_rn(bt_row(vv, gx), bt_row(vv, gy));
    }
  }
#pragma unroll
  for (int uv = 0; uv < 16; ++uv)
    *reinterpret_cast<Word*>(v + ((int64_t)uv * Tp + t) * Cp + c) = out[uv];
}

// The 16 products and A^T M A for one block of kMt tiles x kNt channels
// over the (uv, chunk) steps [z * per_split, (z + 1) * per_split); y in
// bf16, or (yacc != nullptr) the partial sums into plane z of the f32
// scratch
__global__ void __launch_bounds__(kThreads, 1)
winograd_products_kernel(const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ ut,
                         __nv_bfloat16* __restrict__ y,
                         float* __restrict__ yacc, int64_t n_out, int H,
                         int W, int F,
                         int T, int Tp, int Cp, int Fp, int nth, int ntw,
                         int per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * (kNt / kWarpsN);
  const int t0 = blockIdx.x * kMt, f0 = blockIdx.y * kNt;
  const int nk = Cp / kKc;
  const int it0 = blockIdx.z * per_split;
  const int n_it = min(16 * nk - it0, per_split);

  // stage fill, 16 bytes a copy: V rows [kMt][kKc], U^T rows
  // [kNt][kKc]; every row is inside the padded buffers
  constexpr int kRowCopies = kKc / 8;
  auto load_stage = [&](int stage, int it) {
    const int uv = it / nk, c0 = (it % nk) * kKc;
    __nv_bfloat16* sa = sm + stage * kStageElems;
    __nv_bfloat16* sb = sa + kMt * kLd;
    const __nv_bfloat16* va = v + ((int64_t)uv * Tp + t0) * Cp + c0;
#pragma unroll
    for (int j = 0; j < kMt * kRowCopies / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kRowCopies, c = 8 * (i % kRowCopies);
      cp_async16(sa + r * kLd + c, va + (int64_t)r * Cp + c);
    }
    const __nv_bfloat16* ub = ut + ((int64_t)uv * Fp + f0) * Cp + c0;
#pragma unroll
    for (int j = 0; j < kNt * kRowCopies / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kRowCopies, c = 8 * (i % kRowCopies);
      cp_async16(sb + r * kLd + c, ub + (int64_t)r * Cp + c);
    }
  };

  float m[2][kNi][4];       // M_uv: [m16 block][n8 block][element]
  float acc[2][kNi][4][4];  // y: [..][..][..][2a + b]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNi; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[i][j][e] = 0.f;
#pragma unroll
        for (int ab = 0; ab < 4; ++ab) acc[i][j][e][ab] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_it) load_stage(s, it0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1 is no longer read
    if (i + kStages - 1 < n_it)
      load_stage((i + kStages - 1) % kStages, it0 + i + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* sa = sm + (i % kStages) * kStageElems;
    const __nv_bfloat16* sb = sa + kMt * kLd;
#pragma unroll
    for (int k0 = 0; k0 < kKc; k0 += 16) {
      uint32_t a[2][4], b[kNi][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], sa + (wm + 16 * mi + lane % 16) * kLd + k0 +
                               8 * (lane / 16));
#pragma unroll
      for (int nj = 0; nj < kNj; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + (wn + 16 * nj + lane % 8 + 8 * (lane / 16)) *
                                kLd + k0 + 8 * (lane / 8 % 2));
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni)
          mma_bf16(m[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    const int it = it0 + i;
    if (it % nk == nk - 1 || i == n_it - 1) {
      // fold M_uv into y: y_ab += A^T[a][u] A^T[b][v] M_uv (uniform over
      // the block, so the zero terms are skipped without divergence)
      const int u = it / nk / 4, vv = it / nk % 4;
#pragma unroll
      for (int ab = 0; ab < 4; ++ab) {
        const float coef = at(ab / 2, u) * at(ab % 2, vv);
        if (coef != 0.f) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[mi][ni][e][ab] =
                    fmaf(coef, m[mi][ni][e], acc[mi][ni][e][ab]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[mi][ni][e] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: reuse them

  // Epilogue through shared memory, one output row a (of the 2x2) at a
  // time: the warps put their accumulators at [tile][b][channel] (f32),
  // then the block writes each output pixel's 64 channels as whole
  // 16-byte stores (8 bf16, or 4 f32 into the split's plane). Each tile's
  // output offset and in-image mask are computed once, into a table.
  float* stage = reinterpret_cast<float*>(smem);
  int64_t* tile_off = reinterpret_cast<int64_t*>(stage + 2 * kMt * kOutLd);
  unsigned char* tile_ok =
      reinterpret_cast<unsigned char*>(tile_off + kMt);  // bit 2a + b
  if (tid < kMt) {
    const int t = t0 + tid;
    unsigned char ok = 0;
    int64_t off = 0;
    if (t < T) {
      const int tiles_per_img = nth * ntw;
      const int n = t / tiles_per_img, rem = t % tiles_per_img;
      const int row = 2 * (rem / ntw), col = 2 * (rem % ntw);
      off = (((int64_t)n * H + row) * W + col) * F;
#pragma unroll
      for (int ab = 0; ab < 4; ++ab)
        if (row + ab / 2 < H && col + ab % 2 < W) ok |= 1 << ab;
    }
    tile_off[tid] = off;
    tile_ok[tid] = ok;
  }
  const int g = lane / 4, q = lane % 4;
  float* part = yacc == nullptr ? nullptr : yacc + blockIdx.z * n_out;
  const int shift = part != nullptr ? 4 : 3;  // log2(16-byte stores a row)
  const int cw = kNt >> shift;                 // channels a 16-byte store
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a == 1) __syncthreads();  // row a = 0 is written out
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int r = wm + 16 * mi + g + 8 * half;
            *reinterpret_cast<float2*>(
                stage + (2 * r + b) * kOutLd + wn + 8 * ni + 2 * q) =
                make_float2(acc[mi][ni][2 * half][2 * a + b],
                            acc[mi][ni][2 * half + 1][2 * a + b]);
          }
    __syncthreads();
    for (int i = tid; i < (2 * kMt) << shift; i += kThreads) {
      const int rr = i >> shift, c = cw * (i & ((1 << shift) - 1));
      const int b = rr & 1, f = f0 + c;
      if (!(tile_ok[rr >> 1] >> (2 * a + b) & 1) || f >= F) continue;
      const int64_t off = tile_off[rr >> 1] + ((int64_t)a * W + b) * F + f;
      const float* src = stage + rr * kOutLd + c;
      if (part != nullptr) {
        if (F % 4 == 0) {
          *reinterpret_cast<float4*>(part + off) =
              *reinterpret_cast<const float4*>(src);
        } else {
          for (int j = 0; j < 4 && f + j < F; ++j) part[off + j] = src[j];
        }
      } else if (F % 8 == 0) {
        uint4 packed;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[j] = __floats2bfloat162_rn(src[2 * j], src[2 * j + 1]);
        *reinterpret_cast<uint4*>(y + off) = packed;
      } else {
        for (int j = 0; j < 8 && f + j < F; ++j)
          y[off + j] = __float2bfloat16(src[j]);
      }
    }
  }
}

// y = sum over the splits' planes of the f32 scratch, in split order;
// four values a thread where n allows
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ part,
                 __nv_bfloat16* __restrict__ y, int64_t n, int splits) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n % 4 == 0) {
    for (; i < n / 4; i += stride) {
      float4 acc = reinterpret_cast<const float4*>(part)[i];
      for (int z = 1; z < splits; ++z) {
        const float4 p = reinterpret_cast<const float4*>(part + z * n)[i];
        acc.x += p.x;
        acc.y += p.y;
        acc.z += p.z;
        acc.w += p.w;
      }
      __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(y + 4 * i);
      out[0] = __floats2bfloat162_rn(acc.x, acc.y);
      out[1] = __floats2bfloat162_rn(acc.z, acc.w);
    }
    return;
  }
  for (; i < n; i += stride) {
    float acc = part[i];
    for (int z = 1; z < splits; ++z) acc += part[z * n + i];
    y[i] = __float2bfloat16(acc);
  }
}

// U^T [16, Fp, Cp] in bf16 from w [3, 3, C, F] f32, zero where c >= C or
// f >= F: U = G w G^T along the two tap axes, in the plain version's order
// of f32 operations (`winograd_weights`), then rounded to bf16. One block
// per 32 x 32 (f, c) tile: w is read along f, U^T written along c through
// a transpose in shared memory.
constexpr int kWT = 32;

__device__ __forceinline__ void g_rows(const float t[3], float out[4]) {
  out[0] = t[0];
  out[1] = (t[0] + t[1] + t[2]) * 0.5f;
  out[2] = (t[0] - t[1] + t[2]) * 0.5f;
  out[3] = t[2];
}

__global__ void __launch_bounds__(256)
winograd_weights_kernel(const float* __restrict__ w,
                        __nv_bfloat16* __restrict__ ut, int C, int F,
                        int Fp, int Cp) {
  __shared__ __nv_bfloat16 tile[16][kWT][kWT + 2];  // [uv][c][f]
  const int fb = blockIdx.x * kWT, cb = blockIdx.y * kWT;
  const int tx = threadIdx.x % kWT, ty = threadIdx.x / kWT;
  for (int ci = ty; ci < kWT; ci += 256 / kWT) {
    const int c = cb + ci, f = fb + tx;
    float u[4][4] = {};
    if (c < C && f < F) {
      float gw[4][3];  // G along the first tap axis
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float col[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          col[i] = w[((int64_t)(3 * i + j) * C + c) * F + f];
        float rows[4];
        g_rows(col, rows);
#pragma unroll
        for (int a = 0; a < 4; ++a) gw[a][j] = rows[a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) g_rows(gw[a], u[a]);
    }
#pragma unroll
    for (int uv = 0; uv < 16; ++uv)
      tile[uv][ci][tx] = __float2bfloat16(u[uv / 4][uv % 4]);
  }
  __syncthreads();
  for (int fi = ty; fi < kWT; fi += 256 / kWT)
#pragma unroll
    for (int uv = 0; uv < 16; ++uv)
      ut[((int64_t)uv * Fp + fb + fi) * Cp + cb + tx] = tile[uv][tx][fi];
}

}  // namespace

// w: [3, 3, C, F] f32 -> ut: U^T [16, Fp, Cp] bf16, Fp a multiple of 64
// >= F and Cp a multiple of 64 >= C
extern "C" int sdt_winograd_weights_bf16(const float* w, void* ut, int C,
                                         int F, int Fp, int Cp,
                                         void* stream) {
  if (C <= 0 || F <= 0 || Fp % kNt || Fp < F || Cp % kKc || Cp < C ||
      Fp / kWT > 65535 || Cp / kWT > 65535)
    return (int)cudaErrorInvalidValue;
  winograd_weights_kernel<<<dim3(Fp / kWT, Cp / kWT), 256, 0,
                            (cudaStream_t)stream>>>(
      w, static_cast<__nv_bfloat16*>(ut), C, F, Fp, Cp);
  return (int)cudaGetLastError();
}

// x [B, H, W, C] bf16 (C even), ut from sdt_winograd_weights_bf16, v:
// scratch V [16, Tp, Cp] bf16 with Tp a multiple of 128 >= the tile count;
// the products run in ceil(16 * Cp / 64 / per_split) splits: with more
// than one, yacc is an f32 scratch of splits * B*H*W*F values (else null)
// and y is summed from it by a last pass
extern "C" int sdt_winograd_conv_bf16(const void* x, const void* ut,
                                      void* v, float* yacc, void* y, int B,
                                      int H, int W, int C, int F, int Fp,
                                      int Cp, int Tp, int per_split,
                                      void* stream) {
  const int nth = (H + 1) / 2, ntw = (W + 1) / 2;
  const int64_t T = (int64_t)B * nth * ntw;
  const int steps = 16 * (Cp / kKc);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C % 2 ||
      Fp % kNt || Fp < F || Cp % kKc || Cp < C || Tp % kMt || Tp < T ||
      Tp > 0x7fffffff - kMt || Fp / kNt > 65535 || per_split <= 0)
    return (int)cudaErrorInvalidValue;
  const int splits = (steps + per_split - 1) / per_split;
  if (splits > 65535 || (splits > 1) != (yacc != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* vb = static_cast<__nv_bfloat16*>(v);
  if (C % 4 == 0) {
    const int64_t threads = (int64_t)Tp * (Cp / 4);
    winograd_input_kernel<4><<<(unsigned)((threads + 255) / 256), 256, 0,
                               s>>>(xb, vb, H, W, C, (int)T, Tp, Cp, nth,
                                    ntw);
  } else {
    const int64_t threads = (int64_t)Tp * (Cp / 2);
    winograd_input_kernel<2><<<(unsigned)((threads + 255) / 256), 256, 0,
                               s>>>(xb, vb, H, W, C, (int)T, Tp, Cp, nth,
                                    ntw);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_out = (int64_t)B * H * W * F;
  err = cudaFuncSetAttribute(winograd_products_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  winograd_products_kernel<<<dim3(Tp / kMt, Fp / kNt, splits), kThreads,
                             kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(ut), static_cast<__nv_bfloat16*>(y),
      yacc, n_out, H, W, F, (int)T, Tp, Cp, Fp, nth, ntw, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || yacc == nullptr) return (int)err;
  const int64_t blocks = (n_out + 255) / 256;
  split_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                     s>>>(yacc, static_cast<__nv_bfloat16*>(y), n_out,
                          splits);
  return (int)cudaGetLastError();
}
