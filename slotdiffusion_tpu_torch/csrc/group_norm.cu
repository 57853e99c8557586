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
// has a kernel of its own, `gn_bulk_bf16` (below), for every run whose
// length is a multiple of 8, of at most kBulkMaxRun = 98,304 values, on
// 16-byte aligned x and y: all of the repo's models. The values are
// widened to f32 as they are read, the statistics, the f32 affine and the
// SiLU are f32, and y is rounded once to bf16 (round to nearest even), as
// the JAX `_gn_kernel` writes `o_ref.dtype`. Ragged runs (a length not a
// multiple of 8, or x or y not 16-byte aligned) keep the kernels above,
// instantiated on bf16 (a chunk of 4 values one 8-byte access); longer
// runs keep the two-pass path. Bound: 2 * B * C * H * W * 2 bytes over
// 3.35 TB/s.
//
// Why a kernel of its own. On the kernel above the bf16 entry moved half
// the f32 entry's bytes in the same time (12 frames) or 13 % less (192):
// each block ran one run in lockstep (wait, load it all into registers,
// a block sum, a centred sum, FMAs and SiLU, store), with a division by
// HW for the channel of every chunk, twice, and 8-byte accesses. Its
// SiLU costs two multi-function-unit operations a value, so at half the
// bytes the bf16 entry needs twice the f32 entry's arithmetic rate; the
// time is latency, and the design is about runs in flight:
// - runs arrive in shared memory by bulk copy (`cp.async.bulk`, TMA's 1-D
//   form): one thread issues the copy of an item (k consecutive runs, one
//   span of x) into the block's stage, completion on an `mbarrier`;
// - blocks of kBulkThreads = 128, as many an SM as its shared memory
//   holds stages of (up to kBulkPerSm = 8), in one resident wave that
//   walks the items (block b: items b, b + grid, ...). Each block has one
//   stage, refilled once every thread is done with it: 8 blocks an SM
//   with one stage each keep more runs in flight than 1-2 blocks with a
//   ring of 2-4 stages, which this design first had (`PERF.md` §6 has
//   both);
// - the launch plans the call from its shape and the SM count
//   (`bulk_plan` in gn_bulk_plan.cuh, the one place it is decided): k
//   runs an item, the fewest that spread the call over at least one
//   block an SM, at most one run for each team of a block and at most
//   kBulkStage = 8192 values;
// - a run is reduced by a team: a warp where the call's runs are few
//   (its time is one run's chain), 8 lanes where there are kBulkMany or
//   more an SM (more runs at once), grown by powers of two until a thread
//   reads at most kBulkMaxVec = 8 vectors of 8 values a pass. 16-byte
//   `ld.shared`, f32 sums in a fixed order, xor shuffles within the
//   team, one named barrier a sum for a team of several warps. The mean
//   first, then the centred sum, both from shared memory; the team
//   depends on the call's shape alone and nothing is atomic, so two calls
//   give the same bits;
// - the channel of a vector of 8 values is a shift when HW is a power of
//   two (every flagship level), else a multiply by 1/HW corrected by one
//   step; a vector that crosses a channel (HW % 8 != 0) takes each
//   value's channel;
// - the affine: each team keeps its run's C/G scales and shifts in
//   shared memory, two runs' worth (kBulkSlots bytes at most, else read
//   where used), copied in by `cp.async` so that no thread waits on
//   them: its first run's once the block has waited for the kernel ahead
//   (which may have written them: a copy of the weights), beside the
//   first bulk copy, each next run's while this one reduces, all landed
//   before the centred sum's team barrier;
// - y is written once, 16-byte stores from registers (measured faster
//   than computing y in place in the stage and storing it by bulk copy),
//   evict-first (`st.global.cs`) where y is 8 MB or more;
// - programmatic dependent launch: the block waits before its first
//   copy and lets the next kernel be scheduled right after it: the grid
//   is one resident wave, so the next kernel's blocks take only what it
//   leaves free, and a small call's successor is ready when it ends.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_bulk_plan.cuh"

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

// ---- the bf16 entry: runs through shared memory by bulk copy -------------

// its constants and its plan: gn_bulk_plan.cuh
using namespace sdt_gn;
constexpr long long kBulkStream = 8388608;  // y bytes stored evict-first

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a bulk copy that never lands traps (a launch error) instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  do {
    if (++spins == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one float from global to shared memory, asynchronously (completes at
// the issuing thread's `cp.async.wait_all`)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void unpack8(const uint4 u, float v[8]) {
  const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(q[i] << 16);
    v[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float vec_sum(const uint4 u) {
  float v[8];
  unpack8(u, v);
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

__device__ __forceinline__ float vec_sq(const uint4 u, float mean) {
  float v[8];
  unpack8(u, v);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] -= mean;
  return ((v[0] * v[0] + v[1] * v[1]) + (v[2] * v[2] + v[3] * v[3])) +
         ((v[4] * v[4] + v[5] * v[5]) + (v[6] * v[6] + v[7] * v[7]));
}

// y of the 8 values at value `idx` of a run: the affine of their channel
// (`sw`, `sb`: the run's scales and shifts, from its first channel), the
// optional SiLU, rounded to bf16. kChanVec: HW % 8 == 0, so the vector
// lies in one channel; else each value finds its own.
template <bool kSilu, bool kChanVec>
__device__ __forceinline__ uint4 vec_out(const uint4 u, int idx, float rstd,
                                         float mean, const float* sw,
                                         const float* sb, int HW,
                                         int hw_shift, float inv_hw) {
  float v[8];
  unpack8(u, v);
  int c, rem;
  if (hw_shift >= 0) {
    c = idx >> hw_shift;
    rem = idx & (HW - 1);
  } else {
    c = __float2int_rz((float)idx * inv_hw);
    rem = idx - c * HW;
    if (rem < 0) {
      --c;
      rem += HW;
    } else if (rem >= HW) {
      ++c;
      rem -= HW;
    }
  }
  if (kChanVec) {
    const float a = rstd * sw[c];
    const float b = sb[c] - mean * a;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = v[e] * a + b;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (rem == HW) {
        ++c;
        rem = 0;
      }
      const float a = rstd * sw[c];
      v[e] = v[e] * a + (sb[c] - mean * a);
      ++rem;
    }
  }
  if (kSilu) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fdividef(v[e], 1.f + __expf(-v[e]));
  }
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// Sum of `x` over a team of `tsize` threads (8, 16, 32 lanes of a warp,
// or whole warps; kSub: a team may be less than a warp), in a fixed
// order: xor shuffles within the team's lanes; over warps, through
// `slot` (one float a warp; each sum has its own) and named barrier
// 1 + team, in warp order. Every lane of a warp calls it together.
// Either way the team's earlier shared-memory writes are then visible
// to it.
template <bool kSub>
__device__ __forceinline__ float team_sum(float x, int tsize, int team,
                                          float* slot) {
  if (kSub) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < tsize) x += __shfl_xor_sync(0xffffffffu, x, o);
  } else {
    x = warp_sum(x);
  }
  if (tsize <= 32) {
    __syncwarp();
    return x;
  }
  const int warp = threadIdx.x / 32, wpr = tsize / 32;
  if (threadIdx.x % 32 == 0) slot[warp] = x;
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(tsize)
               : "memory");
  float s = 0.f;
  for (int i = team * wpr; i < (team + 1) * wpr; ++i) s += slot[i];
  return s;
}

// Item i: runs [i * k, min(i * k + k, runs)), one contiguous span of x.
// Block b takes items b, b + grid, ... through its one stage of k * L
// values, its teams' affine slots (`slots` bytes, or none) after it. A
// team of tsize threads takes runs team, team + nteams, ... of an item,
// and loads its next run's affine while it reduces this one.
template <bool kSilu, bool kChanVec, bool kSub>
__global__ void __launch_bounds__(kBulkThreads, kBulkPerSm)
gn_bulk_bf16(const __nv_bfloat16* __restrict__ x,
             const float* __restrict__ w, const float* __restrict__ bias,
             __nv_bfloat16* __restrict__ y, int runs, int G, int CG, int HW,
             int hw_shift, float inv_hw, int L, int k, int items,
             int tsize, int slots, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full;
  __shared__ float red_sum[kBulkWarps], red_sq[kBulkWarps];
  const int tid = threadIdx.x;
  const int V = L / 8;  // vectors of 8 values a run
  const int nteams = kBulkThreads / tsize;
  const int team = tid / tsize, tl = tid % tsize;
  // y of kBulkStream bytes or more is stored evict-first: L2 keeps x's
  // lines, which the copies ahead read, over y's, which no one reads here
  const bool stream = (long long)runs * L * 2 >= kBulkStream;
  // a warp's teams go through their runs together (their shuffles take
  // every lane): `lead` is the warp's first team
  const int lead = kSub ? team - team % (tsize < 32 ? 32 / tsize : 1) : team;
  float* slot = slots ? reinterpret_cast<float*>(smem + k * L * 2) +
                            team * 4 * CG
                      : nullptr;
  // the affine of run rr into the team's slot `par` (scales, then shifts)
  auto load_affine = [&](int rr, int par) {
    if (slot == nullptr) return;
    const int c0 = (rr % G) * CG;
    float* s = slot + par * 2 * CG;
    for (int c = tl; c < CG; c += tsize) {
      cp_async4(s + c, w + c0 + c);
      cp_async4(s + CG + c, bias + c0 + c);
    }
  };
  const uint32_t bar = smem_u32(&full);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // programmatic dependent launch: read nothing, x nor the affine (which
  // the kernel ahead may have written: a copy of the weights), before the
  // kernel ahead on the stream has completed
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int mine = (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  auto span = [&](int m, int* nr) {  // the first run of item m, its runs
    const int r0 = ((int)blockIdx.x + m * (int)gridDim.x) * k;
    *nr = min(k, runs - r0);
    return r0;
  };
  auto issue = [&](int m) {  // thread 0: the copy of item m
    int nr;
    const int r0 = span(m, &nr);
    bulk_load(smem_u32(smem), x + (size_t)r0 * L, (uint32_t)(nr * L * 2),
              bar);
  };
  if (tid == 0) issue(0);
  // the first run's affine, beside the bulk copy
  if (team < k && (int)blockIdx.x * k + team < runs)
    load_affine((int)blockIdx.x * k + team, 0);
  // the whole grid is resident (one wave), so the next kernel's blocks
  // may be scheduled at once: they take only what this one leaves free
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  int taken = 0;  // runs this team has taken: its slot's parity
  for (int m = 0; m < mine; ++m) {
    int nr;
    const int r0 = span(m, &nr);
    mbar_wait(bar, (uint32_t)m & 1u);
    const uint4* buf = reinterpret_cast<const uint4*>(smem);
    for (int jb = lead; jb < nr; jb += nteams) {
      const int j = jb + team - lead;
      const bool has = !kSub || j < nr;  // else it joins the shuffles
      const int rr = r0 + j;
      const uint4* run = buf + (size_t)j * V;
      float sum = 0.f;
      if (has) {
#pragma unroll 4
        for (int i = tl; i < V; i += tsize) sum += vec_sum(run[i]);
      }
      const float mean = team_sum<kSub>(sum, tsize, team, red_sum) / L;
      // the team's next run's affine, into its other slot: every thread
      // of the team is past the run that read that slot last
      if (has) {
        int next = -1;
        if (j + nteams < nr) {
          next = rr + nteams;
        } else if (m + 1 < mine) {
          int nn;
          const int r1 = span(m + 1, &nn);
          if (team < nn) next = r1 + team;
        }
        if (next >= 0) load_affine(next, (taken + 1) & 1);
      }
      float sq = 0.f;
      if (has) {
#pragma unroll 4
        for (int i = tl; i < V; i += tsize) sq += vec_sq(run[i], mean);
      }
      // the affine copies of this thread have landed; the team's sum
      // below makes the team's visible to it
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      const float rstd =
          rsqrtf(team_sum<kSub>(sq, tsize, team, red_sq) / L + eps);
      if (!has) continue;
      const float* sw = slot ? slot + (taken & 1) * 2 * CG
                             : w + (rr % G) * CG;
      const float* sb = slot ? sw + CG : bias + (rr % G) * CG;
      uint4* yr = reinterpret_cast<uint4*>(y + (size_t)rr * L);
#pragma unroll 2
      for (int i = tl; i < V; i += tsize) {
        const uint4 o = vec_out<kSilu, kChanVec>(run[i], 8 * i, rstd, mean,
                                                 sw, sb, HW, hw_shift,
                                                 inv_hw);
        if (stream)
          __stcs(yr + i, o);
        else
          yr[i] = o;
      }
      ++taken;
    }
    __syncthreads();  // every thread is done with the stage
    if (tid == 0 && m + 1 < mine) issue(m + 1);
  }
}

template <bool kSilu, bool kChanVec, bool kSub>
cudaError_t launch_bulk_as(const BulkPlan& p, const __nv_bfloat16* x,
                           const float* w, const float* b, __nv_bfloat16* y,
                           int runs, int C, int G, int HW, int L, float eps,
                           cudaStream_t stream) {
  int shift = -1;
  if ((HW & (HW - 1)) == 0)
    for (shift = 0; (1 << shift) < HW; ++shift) {
    }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.grid);
  cfg.blockDim = dim3(kBulkThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gn_bulk_bf16<kSilu, kChanVec, kSub>, x, w,
                            b, y, runs, G, C / G, HW, shift,
                            1.0f / (float)HW, L, p.k, p.items, p.team,
                            p.slots, eps);
}

template <bool kSilu, bool kChanVec, bool kSub>
cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(gn_bulk_bf16<kSilu, kChanVec, kSub>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kBulkSmemSm);
}

cudaError_t launch_bulk(bool silu, const __nv_bfloat16* x, const float* w,
                        const float* b, __nv_bfloat16* y, int runs, int C,
                        int G, int HW, int L, float eps, cudaStream_t s) {
  // per device: its SM count, and leave for every instance of the kernel
  // to take what one block may of shared memory
  static int sms_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    const cudaError_t errs[8] = {
        set_smem_limit<false, false, false>(),
        set_smem_limit<false, false, true>(),
        set_smem_limit<false, true, false>(),
        set_smem_limit<false, true, true>(),
        set_smem_limit<true, false, false>(),
        set_smem_limit<true, false, true>(),
        set_smem_limit<true, true, false>(),
        set_smem_limit<true, true, true>()};
    for (const cudaError_t e : errs)
      if (e != cudaSuccess) return e;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms_of[dev] = n;
  }
  const BulkPlan p = bulk_plan(L, runs, sms_of[dev], C / G);
  const bool vec = HW % 8 == 0, sub = p.team < 32;
#define SDT_BULK_LAUNCH(S, V, T)                                          \
  launch_bulk_as<S, V, T>(p, x, w, b, y, runs, C, G, HW, L, eps, s)
  if (silu)
    return vec ? (sub ? SDT_BULK_LAUNCH(true, true, true)
                      : SDT_BULK_LAUNCH(true, true, false))
               : (sub ? SDT_BULK_LAUNCH(true, false, true)
                      : SDT_BULK_LAUNCH(true, false, false));
  return vec ? (sub ? SDT_BULK_LAUNCH(false, true, true)
                    : SDT_BULK_LAUNCH(false, true, false))
             : (sub ? SDT_BULK_LAUNCH(false, false, true)
                    : SDT_BULK_LAUNCH(false, false, false));
#undef SDT_BULK_LAUNCH
}

// The bf16 entry: runs of the bulk route (`bulk_route`) take
// `gn_bulk_bf16` on the plan computed here (`work` null, `chunk` 0); the
// rest the kernels of the f32 entry on bf16 (`work` and `chunk` as there).
int group_norm_bf16(const __nv_bfloat16* x, const float* w, const float* b,
                    __nv_bfloat16* y, int B, int C, int HW, int G,
                    float eps, int silu, float* work, int chunk,
                    void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G)
    return (int)cudaErrorInvalidValue;
  const long long Lll = (long long)(C / G) * HW;
  const long long runs_ll = (long long)B * G;
  if (Lll > 0x7fffffffLL || runs_ll > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!bulk_route(Lll, (((uintptr_t)x | (uintptr_t)y) & 15) == 0))
    return group_norm(x, w, b, y, B, C, HW, G, eps, silu, work, chunk,
                      stream);
  if (work != nullptr || chunk != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_bulk(silu, x, w, b, y, (int)runs_ll, C, G, HW,
                          (int)Lll, eps, (cudaStream_t)stream);
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

// x, y: contiguous bf16 [B, C, H*W]; w, b: f32 [C]. Runs of the bulk
// route (`bulk_route` in gn_bulk_plan.cuh) take a null `work` and a 0
// `chunk`; the rest as the f32 entry
extern "C" int sdt_group_norm_bf16(const void* x, const float* w,
                                   const float* b, void* y, int B, int C,
                                   int HW, int G, float eps, int silu,
                                   float* work, int chunk, void* stream) {
  return group_norm_bf16(static_cast<const __nv_bfloat16*>(x), w, b,
                         static_cast<__nv_bfloat16*>(y), B, C, HW, G, eps,
                         silu, work, chunk, stream);
}
