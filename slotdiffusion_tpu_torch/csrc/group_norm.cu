// GroupNorm(+SiLU) over contiguous f32 or bf16 NCHW, one read of x, one
// write of y.
//
// Replaces the Pallas kernel `_gn_kernel` driven by `_gn_pallas` /
// `fused_group_norm` (the JAX package's ops/fused_norm.py:53, 83-103, 127):
// per (sample, group) the f32 mean and biased variance, the affine folded
// into y = x * a + b (a = rstd * w_c, b = beta_c - mean * a), then an
// optional SiLU.
//
// In NCHW the channels of one group are contiguous, so a (sample, group) is
// one contiguous run of L = C / G * H * W values. A run is held in
// registers (16 values a thread up to L = 4096, 32 above), so x is read
// once: the sum and the mean first, then the centered sum of squares from
// the registers, as the plain version does; then y.
//
// Design (H100). The time is set by bytes where a call is large and by the
// launch where it is small (at B = 12 most UNet calls move under 1 MB;
// ~2 us is the floor of a launch behind another), so:
// - threads a run (tpr): the least power of two from 32 that holds the run
//   at 16 values a thread up to L = 4096 (32 threads up to L = 512, 256 at
//   4096) and at 32 values above (512 at the flagship's largest L = 12288,
//   1024 at MAX_GROUP = 32768): above 4096 fewer, fuller threads let an SM
//   hold more runs at once;
// - runs of up to 512 values go one warp each, two runs a block of 64 (so
//   a small call spreads over more SMs), and reduce with warp shuffles
//   alone; longer runs take tpr threads, a block each, and add the warps'
//   sums through shared memory in warp order (no atomics: a call is
//   deterministic), one barrier a sum;
// - each chunk's scale and shift are read with its x (runs of up to 4096),
//   so the chain of a call is: loads, two reductions, one pass of FMAs and
//   the SiLU (`__expf`, `__fdividef`: ~1e-6 relative), stores;
// - programmatic dependent launch: the grid is scheduled while the kernel
//   ahead of it on the stream finishes and waits for it inside
//   (griddepcontrol.wait before the first read), and lets the next kernel
//   be scheduled once its statistics are done, which takes most of the
//   launch off the chain of back-to-back calls;
// - 16-byte loads and stores where L is a multiple of 4 and x and y are
//   16-byte aligned, with the channel of each vector computed once when
//   H * W is a multiple of 4 (else per value: the ragged (5, 96, 7, 9) with
//   24 groups has runs of 252 values, channels of 63); 4-byte accesses,
//   in the same register layout, otherwise.
//
// Bound on the H100: ~8-12 flops per 8 bytes moved, far below the card's
// f32 balance, so bytes: 2 * B * C * H * W * 4 bytes over 3.35 TB/s.
//
// The bf16 entry point (`sdt_group_norm_bf16`, the model under `use_bf16`)
// is the same kernel on bf16 x and y, as the JAX `_gn_kernel` writes
// `o_ref.dtype`: the values are widened to f32 as they are loaded, the
// statistics, the f32 affine and the SiLU are f32, and y is rounded once
// to bf16 (round to nearest even) on the store. A chunk of 4 values is
// one 8-byte access. Bound: half the f32 entry's bytes,
// 2 * B * C * H * W * 2 over 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // threads a block for runs of <= 2 warps
constexpr int kMaxRun = 32768;   // MAX_GROUP in ops/fused_norm.py

// 4 consecutive values as f32: one 16-byte (f32) or 8-byte (bf16) load
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, const float o[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float o[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void set(float& dst, float x) { dst = x; }
__device__ __forceinline__ void set(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of `x` over the `tpr` threads of each run of the block, through
// `red` (one slot a warp; each sum of a call has its own `red`, so one
// barrier serves it); every thread of the block calls it.
__device__ __forceinline__ float run_sum(float x, int tpr, float* red) {
  x = warp_sum(x);
  if (tpr == 32) return x;
  const int warp = threadIdx.x / 32, per = tpr / 32;
  if (threadIdx.x % 32 == 0) red[warp] = x;
  __syncthreads();
  const int first = warp / per * per;
  float s = 0.f;
  for (int i = 0; i < per; ++i) s += red[first + i];
  return s;
}

// A thread holds up to kN chunks of 4 consecutive values of its run (kN =
// 4 up to L = 4096, 8 above), in f32 whatever T is. kVec: each chunk is
// one 16-byte (f32) or 8-byte (bf16) access (L % 4 == 0, aligned), else
// four single-value accesses with the run's ragged end masked; kChanVec:
// a chunk lies in one channel (H * W % 4 == 0), else each value finds its
// channel. With kN = 4 and kChanVec the chunk's scale and shift are read
// with x, so their latency overlaps the loads.
template <typename T, int kN, bool kVec, bool kChanVec, bool kSilu>
__global__ void __launch_bounds__(1024)
gn_silu_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y,
               int runs, int G, int CG, int HW, int L, int tpr, float eps) {
  constexpr bool kEarly = kChanVec && kN == 4;  // affine read with x
  __shared__ float red_sum[1024 / 32], red_sq[1024 / 32];
  // programmatic dependent launch: read nothing before the kernel ahead
  // on the stream has completed
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int run = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const int r = threadIdx.x % tpr;
  const int n = run < runs ? (L + 3) / 4 : 0;  // chunks of this run
  const size_t base = (size_t)run * L;
  const int c0 = (run % G) * CG;  // first channel of the run
  float v[kN][4];
  float cw[kN], cb[kN];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int i = r + j * tpr;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) {
      if (kVec) {
        q = load4(x + base + 4 * i);
      } else {
        const T* p = x + base + 4 * i;
        const int left = L - 4 * i;  // >= 1
        q.x = to_f32(p[0]);
        if (left > 1) q.y = to_f32(p[1]);
        if (left > 2) q.z = to_f32(p[2]);
        if (left > 3) q.w = to_f32(p[3]);
      }
      if (kEarly) {
        const int c = c0 + 4 * i / HW;
        cw[j] = w[c];
        cb[j] = bias[c];
      }
    }
    v[j][0] = q.x;
    v[j][1] = q.y;
    v[j][2] = q.z;
    v[j][3] = q.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += v[j][e];  // masked values are 0
  }
  const float mean = run_sum(sum, tpr, red_sum) / L;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int i = r + j * tpr;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c = i < n && (kVec || 4 * i + e < L) ? v[j][e] - mean : 0.f;
      sq += c * c;
    }
  }
  const float rstd = rsqrtf(run_sum(sq, tpr, red_sq) / L + eps);
  // the next kernel may be scheduled while this one writes y (earlier, its
  // waiting blocks would hold SM slots during the reductions)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (run >= runs) return;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int i = r + j * tpr;
    if (i >= n) continue;
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + (kChanVec ? 4 * i : 4 * i + e) / HW;
      const float a = rstd * (kEarly ? cw[j] : w[c]);
      float t = v[j][e] * a + ((kEarly ? cb[j] : bias[c]) - mean * a);
      if (kSilu) t = __fdividef(t, 1.f + __expf(-t));
      o[e] = t;
    }
    if (kVec) {
      store4(y + base + 4 * i, o);
    } else {
      T* p = y + base + 4 * i;
      const int left = L - 4 * i;
      set(p[0], o[0]);
      if (left > 1) set(p[1], o[1]);
      if (left > 2) set(p[2], o[2]);
      if (left > 3) set(p[3], o[3]);
    }
  }
}

// Launched with programmatic stream serialization: on Hopper the grid is
// scheduled while the kernel before it on the stream finishes, and waits
// for it inside (griddepcontrol.wait), which takes the launch off the
// critical path of back-to-back small calls.
template <typename T, int kN, bool kVec, bool kChanVec>
cudaError_t launch(bool silu, dim3 grid, int block, cudaStream_t stream,
                   const T* x, const float* w, const float* b, T* y,
                   int runs, int G, int CG, int HW, int L, int tpr,
                   float eps) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (silu)
    return cudaLaunchKernelEx(
        &cfg, gn_silu_kernel<T, kN, kVec, kChanVec, true>, x, w, b, y, runs,
        G, CG, HW, L, tpr, eps);
  return cudaLaunchKernelEx(
      &cfg, gn_silu_kernel<T, kN, kVec, kChanVec, false>, x, w, b, y, runs,
      G, CG, HW, L, tpr, eps);
}

template <typename T, int kN>
cudaError_t launch_any(bool vec, bool chan_vec, bool silu, dim3 grid,
                       int block, cudaStream_t s, const T* x,
                       const float* w, const float* b, T* y, int runs,
                       int G, int CG, int HW, int L, int tpr, float eps) {
  if (vec && chan_vec)
    return launch<T, kN, true, true>(silu, grid, block, s, x, w, b, y, runs,
                                     G, CG, HW, L, tpr, eps);
  if (vec)
    return launch<T, kN, true, false>(silu, grid, block, s, x, w, b, y,
                                      runs, G, CG, HW, L, tpr, eps);
  return launch<T, kN, false, false>(silu, grid, block, s, x, w, b, y, runs,
                                     G, CG, HW, L, tpr, eps);
}

template <typename T>
int group_norm(const T* x, const float* w, const float* b, T* y, int B,
               int C, int HW, int G, float eps, int silu, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G)
    return (int)cudaErrorInvalidValue;
  const long long Lll = (long long)(C / G) * HW;
  const long long runs_ll = (long long)B * G;
  if (Lll > kMaxRun || runs_ll > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int L = (int)Lll, runs = (int)runs_ll;
  // 16 values a thread up to L = 4096, 32 above (fewer, fuller threads
  // hold more runs an SM at once)
  const int per_thread = L <= 4096 ? 16 : 32;
  int tpr = 32;
  while (tpr * per_thread < L) tpr *= 2;
  const int block = tpr > kBlock ? tpr : kBlock;
  const dim3 grid((unsigned)((runs + block / tpr - 1) / (block / tpr)));
  const bool vec = L % 4 == 0 &&
      (((uintptr_t)x | (uintptr_t)y) & (4 * sizeof(T) - 1)) == 0;
  const bool chan_vec = vec && HW % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      L <= 4096
          ? launch_any<T, 4>(vec, chan_vec, silu, grid, block, s, x, w, b,
                             y, runs, G, C / G, HW, L, tpr, eps)
          : launch_any<T, 8>(vec, chan_vec, silu, grid, block, s, x, w, b,
                             y, runs, G, C / G, HW, L, tpr, eps);
  return (int)err;
}

}  // namespace

// x, y: contiguous f32 [B, C, H*W]; w, b: f32 [C]
extern "C" int sdt_group_norm_f32(const float* x, const float* w,
                                  const float* b, float* y, int B, int C,
                                  int HW, int G, float eps, int silu,
                                  void* stream) {
  return group_norm(x, w, b, y, B, C, HW, G, eps, silu, stream);
}

// x, y: contiguous bf16 [B, C, H*W]; w, b: f32 [C]
extern "C" int sdt_group_norm_bf16(const void* x, const float* w,
                                   const float* b, void* y, int B, int C,
                                   int HW, int G, float eps, int silu,
                                   void* stream) {
  return group_norm(static_cast<const __nv_bfloat16*>(x), w, b,
                    static_cast<__nv_bfloat16*>(y), B, C, HW, G, eps, silu,
                    stream);
}
