// 3x3 stride-1 SAME convolution (no bias) by Winograd F(2x2, 3x3), bf16.
//
// Replaces the Pallas kernel `_wino_kernel` driven by `_wino_call` /
// `winograd_conv3x3` (the JAX package's ops/winograd_conv.py:78-150,
// 180-198).
//
//   x [B, H, W, C] bf16 (NHWC), U^T [16, F, C] bf16 (U = G g G^T), y [B, H,
//   W, F] bf16; per 4x4 input tile d (stride 2, zero padding 1):
//     V_uv = (B^T d B)_uv                    in f32, rounded to bf16
//     M_uv = sum_c V_uv[c] * U_uv[c, :]      bf16 operands, f32 sums
//     y    = A^T M A                         2x2 outputs, f32, then bf16
//
// B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]],
// A^T = [[1,1,1,0],[0,1,-1,-1]]. The rounding points are the JAX kernel's:
// V and U in bf16, every product exact in f32, every sum in f32.
//
// Design: a first small kernel turns w into U^T [16, F, C] (zero-padded
// to blocks of 32 channels), in the plain version's f32 order, then bf16.
// The convolution runs one block of 16 warps per (64 tiles, 32 output
// channels). The block walks C in chunks of 32: it builds all 16 V_uv of
// its tiles for the chunk in shared memory (each from the tile's 16 input
// values, two channels a load), stages the chunk of U^T beside them (16
// bytes a load), and each warp runs the 16 products of its 16 tiles x 8
// channels as bf16 tensor-core MMAs (mma.sync m16n8k16, f32 accumulators
// in registers: 16 x 4 per thread). After the last chunk the warp folds
// its 16 M_uv into the 2x2 outputs in registers and writes y once. Rows
// of the shared tiles are padded to 40 values so the fragment loads hit 32
// distinct banks. Ragged edges (tiles past B*ceil(H/2)*ceil(W/2), channels
// past C or F, an odd H or W) are masked; reads outside the image are the
// SAME zeros.
//
// Bound on the H100: the 16 products are 8*B*H*W*C*F operations on bf16
// operands (989 TFLOP/s dense) against x, U and y moved once; at the
// flagship UNet's conv shapes the two are within 2x of each other (a few
// microseconds). What bounds this kernel instead is building V: every
// output-channel block rebuilds its tiles' V from x (F/32 times), the
// loads of a chunk are not overlapped with its MMAs (one block per SM),
// a small B*H*W/4 leaves most SMs idle at the deep levels, and mma.sync
// reaches a fraction of the wgmma rate. One V per tile, a pipeline of
// chunks (cp.async/TMA), split-K and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;      // 16 warps: 4 along tiles x 4 along F
constexpr int kTT = 64;            // tiles per block
constexpr int kTF = 32;            // output channels per block
constexpr int kCK = 32;            // input channels per chunk (2 MMA k-steps)
constexpr int kLd = kCK + 8;       // padded shared row, in bf16 values
constexpr int kSmemBytes = 16 * (kTT + kTF) * kLd * 2;
constexpr int kVItems = kTT * kCK / 2 / kThreads;       // (tile, 2 ch)
constexpr int kUItems = 16 * kTF * kCK / 8 / kThreads;  // 16-byte loads

// (B^T r)[u] over four values, in the JAX kernel's order of terms
__device__ __forceinline__ float bt_row(int u, const float r[4]) {
  switch (u) {
    case 0: return r[0] - r[2];
    case 1: return r[1] + r[2];
    case 2: return r[2] - r[1];
    default: return r[1] - r[3];
  }
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads, 1)
winograd_f2x2_3x3_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ ut,
                         __nv_bfloat16* __restrict__ y, int B, int H, int W,
                         int C, int F, int Fp, int Cp, int nth, int ntw) {
  extern __shared__ __align__(16) unsigned char smem[];
  // vs[uv][tile][c], us[uv][f][c]
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* us = vs + 16 * kTT * kLd;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;      // MMA fragment coordinates
  const int wt = (warp % 4) * 16;             // the warp's tiles in the block
  const int wf = (warp / 4) * 8;              // the warp's channels
  const int tiles_per_img = nth * ntw;
  const int T = B * tiles_per_img;
  const int t0 = blockIdx.x * kTT;
  const int f0 = blockIdx.y * kTF;

  // V staging: item k of this thread is tile (tid + kThreads k) / 16 of
  // the block and input channels 2 * (tid % 16) + {0, 1} of each chunk; its
  // patch origin and the in-image mask of its 16 taps do not change
  // across chunks
  int64_t base[kVItems];
  uint32_t taps[kVItems];
#pragma unroll
  for (int k = 0; k < kVItems; ++k) {
    const int t = t0 + (tid + kThreads * k) / (kCK / 2);
    taps[k] = 0;
    base[k] = 0;
    if (t < T) {
      const int n = t / tiles_per_img, rem = t % tiles_per_img;
      const int row0 = 2 * (rem / ntw) - 1, col0 = 2 * (rem % ntw) - 1;
      base[k] = (((int64_t)n * H + row0) * W + col0) * C;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (row0 + r >= 0 && row0 + r < H && col0 + s >= 0 &&
              col0 + s < W)
            taps[k] |= 1u << (4 * r + s);
    }
  }

  float acc[16][4];
#pragma unroll
  for (int uv = 0; uv < 16; ++uv)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[uv][i] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCK) {
    // U^T of kTF channels x kCK input channels for all 16 uv, 16 bytes a
    // load (U^T is padded to [16, Fp, Cp], so no load is ragged)
#pragma unroll
    for (int j = 0; j < kUItems; ++j) {
      const int item = tid + kThreads * j;
      const int cg = item % (kCK / 8);
      const int f = (item / (kCK / 8)) % kTF;
      const int uv = item / (kCK / 8 * kTF);
      *reinterpret_cast<uint4*>(us + (uv * kTF + f) * kLd + 8 * cg) =
          *reinterpret_cast<const uint4*>(
              ut + ((int64_t)uv * Fp + f0 + f) * Cp + c0 + 8 * cg);
    }
    // all 16 V_uv of kTT tiles x kCK channels, two channels a thread
#pragma unroll
    for (int k = 0; k < kVItems; ++k) {
      const int ti = (tid + kThreads * k) / (kCK / 2);
      const int c = 2 * (tid % (kCK / 2));
      const bool in_c = c0 + c < C;  // C is even: both channels or none
      float2 d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          d[r][s] = make_float2(0.f, 0.f);
          if (in_c && (taps[k] >> (4 * r + s) & 1u))
            d[r][s] = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    x + base[k] + ((int64_t)r * W + s) * C + c0 + c));
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float gx[4], gy[4];  // row transform first, as the JAX kernel
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float cx[4] = {d[0][s].x, d[1][s].x, d[2][s].x, d[3][s].x};
          const float cy[4] = {d[0][s].y, d[1][s].y, d[2][s].y, d[3][s].y};
          gx[s] = bt_row(u, cx);
          gy[s] = bt_row(u, cy);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
          *reinterpret_cast<__nv_bfloat162*>(
              vs + ((4 * u + v) * kTT + ti) * kLd + c) =
              __floats2bfloat162_rn(bt_row(v, gx), bt_row(v, gy));
      }
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kCK; k0 += 16) {
#pragma unroll
      for (int uv = 0; uv < 16; ++uv) {
        const __nv_bfloat16* va =
            vs + (uv * kTT + wt + g) * kLd + k0 + 2 * q;
        const uint32_t a[4] = {ld32(va), ld32(va + 8 * kLd), ld32(va + 8),
                               ld32(va + 8 * kLd + 8)};
        const __nv_bfloat16* ub = us + (uv * kTF + wf + g) * kLd + k0 + 2 * q;
        const uint32_t b[2] = {ld32(ub), ld32(ub + 8)};
        mma_bf16(acc[uv], a, b);
      }
    }
    __syncthreads();
  }

  // A^T M A per accumulator element: Z_ub = sum_v A^T[b,v] M_uv, then
  // y_ab = sum_u A^T[a,u] Z_ub, with A^T = [[1,1,1,0],[0,1,-1,-1]]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float z[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      z[u][0] = acc[4 * u][i] + acc[4 * u + 1][i] + acc[4 * u + 2][i];
      z[u][1] = acc[4 * u + 1][i] - acc[4 * u + 2][i] - acc[4 * u + 3][i];
    }
    const int t = t0 + wt + g + (i >= 2 ? 8 : 0);
    const int ff = f0 + wf + 2 * q + (i & 1);
    if (t >= T || ff >= F) continue;
    const int n = t / tiles_per_img;
    const int rem = t % tiles_per_img;
    const int ti = rem / ntw, tj = rem % ntw;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int row = 2 * ti + a, col = 2 * tj + b;
        if (row >= H || col >= W) continue;
        const float val = a == 0 ? z[0][b] + z[1][b] + z[2][b]
                                 : z[1][b] - z[2][b] - z[3][b];
        y[(((int64_t)n * H + row) * W + col) * F + ff] =
            __float2bfloat16(val);
      }
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

// w: [3, 3, C, F] f32; ut: scratch for U^T [16, Fp, Cp] bf16, Fp a
// multiple of 32 >= F and Cp a multiple of 32 >= C; C must be even
extern "C" int sdt_winograd_f2x2_3x3_bf16(const void* x, const float* w,
                                          void* ut, void* y, int B, int H,
                                          int W, int C, int F, int Fp,
                                          int Cp, void* stream) {
  const int nth = (H + 1) / 2, ntw = (W + 1) / 2;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C % 2 ||
      Fp % kTF || Fp < F || Cp % kCK || Cp < C ||
      (int64_t)B * nth * ntw + kTT > 0x7fffffff || Fp / kTF > 65535)
    return (int)cudaErrorInvalidValue;
  const int T = B * nth * ntw;
  const int blocks = (T + kTT - 1) / kTT;
  winograd_weights_kernel<<<dim3(Fp / kWT, Cp / kWT), 256, 0,
                            (cudaStream_t)stream>>>(
      w, static_cast<__nv_bfloat16*>(ut), C, F, Fp, Cp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      winograd_f2x2_3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks, Fp / kTF);
  winograd_f2x2_3x3_kernel<<<grid, kThreads, kSmemBytes,
                             (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(ut), static_cast<__nv_bfloat16*>(y),
      B, H, W, C, F, Fp, Cp, nth, ntw);
  return (int)cudaGetLastError();
}
