// GroupNorm(+SiLU) over contiguous f32 or bf16 NCHW, any (sample, group)
// run length: one read of x and one write of y for runs of up to
// kMaxRun = 32768 values, two reads of x above.
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
// Runs longer than kMaxRun (the 384-channel norm of the UNet's output
// level 0 at 56x56 latents: 37,632 values; the pixel decoder at 64x64:
// 49,152; a dVAE-sized 128 channels at 128x128 in 4 groups: 65,536) take
// two passes, design (b) of the two that fit:
// - `gn_long_stats`: one block of kLongThreads a chunk of at most
//   kLongChunk = 8192 values (32 a thread, in registers) writes the
//   chunk's mean and centered sum of squares (M2) to a workspace;
// - `gn_long_apply`: one block a chunk combines its run's partials by
//   Chan's formula in chunk order (n = n_a + n_b, d = mean_b - mean_a,
//   mean += d * n_b / n, M2 += M2_b + d^2 * n_a * n_b / n), so every
//   block of a run gets the same statistics, bit for bit, with no atomics;
//   then reads its chunk of x again and writes y.
// The host plans the chunks (`long_plan` in ops/fused_norm.py: as few
// chunks as kLongChunk allows, equal sizes rounded up to a multiple of 4,
// the last one shorter) and passes the chunk size and the workspace; a
// call is deterministic. Why (b) and not a thread-block cluster holding a
// run in the registers of 2-8 blocks: (b) takes any run length where a
// cluster stops at 8 x 32768, and its blocks need no co-scheduling, so
// it launches at any batch. It reads x twice: its bound is 1.5 times the
// bytes, 3 * B * C * H * W * sizeof(x) over 3.35 TB/s. Programmatic
// dependent launch stays on the short path; the long path's two kernels
// are plain launches on the stream.
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
constexpr int kLongThreads = 256;  // a block of the long path
constexpr int kLongN = 8;          // chunks of 4 values a thread
constexpr int kLongChunk = kLongThreads * kLongN * 4;  // LONG_CHUNK

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

// Four values of a run at `p` (`left` of them valid, >= 1) as f32: one
// vector load with kVec, else single-value loads with the rest 0.
template <typename T, bool kVec>
__device__ __forceinline__ float4 load_chunk(const T* p, int left) {
  if (kVec) return load4(p);
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  q.x = to_f32(p[0]);
  if (left > 1) q.y = to_f32(p[1]);
  if (left > 2) q.z = to_f32(p[2]);
  if (left > 3) q.w = to_f32(p[3]);
  return q;
}

// Long path, pass 1: block b is chunk b % nchunk of run b / nchunk; it
// writes (mean, M2) of its values to part[b].
template <typename T, bool kVec>
__global__ void __launch_bounds__(kLongThreads)
gn_long_stats(const T* __restrict__ x, float2* __restrict__ part, int L,
              int chunk, int nchunk) {
  __shared__ float red_sum[kLongThreads / 32], red_sq[kLongThreads / 32];
  const int run = blockIdx.x / nchunk, k = blockIdx.x % nchunk;
  const int start = k * chunk;
  const int len = min(chunk, L - start);
  const int n = (len + 3) / 4;
  const T* p = x + (size_t)run * L + start;
  float v[kLongN][4];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kLongN; ++j) {
    const int i = threadIdx.x + j * kLongThreads;
    const float4 q = i < n ? load_chunk<T, kVec>(p + 4 * i, len - 4 * i)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    v[j][0] = q.x;
    v[j][1] = q.y;
    v[j][2] = q.z;
    v[j][3] = q.w;
    sum += q.x + q.y + q.z + q.w;  // masked values are 0
  }
  const float mean = run_sum(sum, kLongThreads, red_sum) / len;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kLongN; ++j) {
    const int i = threadIdx.x + j * kLongThreads;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c = i < n && 4 * i + e < len ? v[j][e] - mean : 0.f;
      sq += c * c;
    }
  }
  const float m2 = run_sum(sq, kLongThreads, red_sq);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(mean, m2);
}

// Long path, pass 2: the run's statistics from its partials (Chan's
// formula, chunk order), then y of this block's chunk.
template <typename T, bool kVec, bool kChanVec, bool kSilu>
__global__ void __launch_bounds__(kLongThreads)
gn_long_apply(const T* __restrict__ x, const float2* __restrict__ part,
              const float* __restrict__ w, const float* __restrict__ bias,
              T* __restrict__ y, int G, int CG, int HW, int L, int chunk,
              int nchunk, float eps) {
  __shared__ float stat[2];
  const int run = blockIdx.x / nchunk, k = blockIdx.x % nchunk;
  if (threadIdx.x == 0) {
    const float2* pr = part + (size_t)run * nchunk;
    float na = 0.f, mean = 0.f, m2 = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      const float2 q = pr[c];
      const float nb = (float)min(chunk, L - c * chunk);
      const float nt = na + nb;
      const float d = q.x - mean;
      mean += d * (nb / nt);
      m2 += q.y + d * d * (na * nb / nt);
      na = nt;
    }
    stat[0] = mean;
    stat[1] = rsqrtf(m2 / L + eps);
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  const int start = k * chunk;
  const int len = min(chunk, L - start);
  const int n = (len + 3) / 4;
  const size_t base = (size_t)run * L + start;
  const int c0 = (run % G) * CG;
#pragma unroll
  for (int j = 0; j < kLongN; ++j) {
    const int i = threadIdx.x + j * kLongThreads;
    if (i >= n) continue;
    const int left = len - 4 * i;
    const float4 q = load_chunk<T, kVec>(x + base + 4 * i, left);
    const float v[4] = {q.x, q.y, q.z, q.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + (start + (kChanVec ? 4 * i : 4 * i + e)) / HW;
      const float a = rstd * w[c];
      float t = v[e] * a + (bias[c] - mean * a);
      if (kSilu) t = __fdividef(t, 1.f + __expf(-t));
      o[e] = t;
    }
    T* py = y + base + 4 * i;
    if (kVec) {
      store4(py, o);
    } else {
      set(py[0], o[0]);
      if (left > 1) set(py[1], o[1]);
      if (left > 2) set(py[2], o[2]);
      if (left > 3) set(py[3], o[3]);
    }
  }
}

template <typename T, bool kVec, bool kChanVec>
cudaError_t launch_long(bool silu, int blocks, cudaStream_t s, const T* x,
                        const float* w, const float* b, T* y, float2* part,
                        int G, int CG, int HW, int L, int chunk, int nchunk,
                        float eps) {
  gn_long_stats<T, kVec><<<blocks, kLongThreads, 0, s>>>(x, part, L, chunk,
                                                         nchunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (silu)
    gn_long_apply<T, kVec, kChanVec, true><<<blocks, kLongThreads, 0, s>>>(
        x, part, w, b, y, G, CG, HW, L, chunk, nchunk, eps);
  else
    gn_long_apply<T, kVec, kChanVec, false><<<blocks, kLongThreads, 0, s>>>(
        x, part, w, b, y, G, CG, HW, L, chunk, nchunk, eps);
  return cudaGetLastError();
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
               int C, int HW, int G, float eps, int silu, float* work,
               int chunk, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G)
    return (int)cudaErrorInvalidValue;
  const long long Lll = (long long)(C / G) * HW;
  const long long runs_ll = (long long)B * G;
  if (Lll > 0x7fffffffLL || runs_ll > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int L = (int)Lll, runs = (int)runs_ll;
  const bool vec = L % 4 == 0 &&
      (((uintptr_t)x | (uintptr_t)y) & (4 * sizeof(T) - 1)) == 0;
  const bool chan_vec = vec && HW % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (L > kMaxRun) {
    // the host's plan: chunks of `chunk` values (a multiple of 4), the
    // last one shorter; `work` holds a float2 a chunk of every run
    if (work == nullptr || chunk <= 0 || chunk % 4 || chunk > kLongChunk)
      return (int)cudaErrorInvalidValue;
    const long long nchunk = (Lll + chunk - 1) / chunk;
    if (runs_ll * nchunk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int blocks = (int)(runs_ll * nchunk);
    float2* part = reinterpret_cast<float2*>(work);
    const int CG = C / G, nc = (int)nchunk;
    const cudaError_t err =
        vec && chan_vec
            ? launch_long<T, true, true>(silu, blocks, s, x, w, b, y, part,
                                         G, CG, HW, L, chunk, nc, eps)
        : vec ? launch_long<T, true, false>(silu, blocks, s, x, w, b, y,
                                            part, G, CG, HW, L, chunk, nc,
                                            eps)
              : launch_long<T, false, false>(silu, blocks, s, x, w, b, y,
                                             part, G, CG, HW, L, chunk, nc,
                                             eps);
    return (int)err;
  }
  // 16 values a thread up to L = 4096, 32 above (fewer, fuller threads
  // hold more runs an SM at once)
  const int per_thread = L <= 4096 ? 16 : 32;
  int tpr = 32;
  while (tpr * per_thread < L) tpr *= 2;
  const int block = tpr > kBlock ? tpr : kBlock;
  const dim3 grid((unsigned)((runs + block / tpr - 1) / (block / tpr)));
  const cudaError_t err =
      L <= 4096
          ? launch_any<T, 4>(vec, chan_vec, silu, grid, block, s, x, w, b,
                             y, runs, G, C / G, HW, L, tpr, eps)
          : launch_any<T, 8>(vec, chan_vec, silu, grid, block, s, x, w, b,
                             y, runs, G, C / G, HW, L, tpr, eps);
  return (int)err;
}

}  // namespace

// x, y: contiguous f32 [B, C, H*W]; w, b: f32 [C]; runs of C / G * H * W
// over kMaxRun values take the long path with `chunk` values a chunk and
// `work` (f32, 2 a chunk of every run); null and 0 otherwise
extern "C" int sdt_group_norm_f32(const float* x, const float* w,
                                  const float* b, float* y, int B, int C,
                                  int HW, int G, float eps, int silu,
                                  float* work, int chunk, void* stream) {
  return group_norm(x, w, b, y, B, C, HW, G, eps, silu, work, chunk,
                    stream);
}

// x, y: contiguous bf16 [B, C, H*W]; the rest as the f32 entry
extern "C" int sdt_group_norm_bf16(const void* x, const float* w,
                                   const float* b, void* y, int B, int C,
                                   int HW, int G, float eps, int silu,
                                   float* work, int chunk, void* stream) {
  return group_norm(static_cast<const __nv_bfloat16*>(x), w, b,
                    static_cast<__nv_bfloat16*>(y), B, C, HW, G, eps, silu,
                    work, chunk, stream);
}
