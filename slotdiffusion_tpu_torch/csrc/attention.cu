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
//
// The bf16 entry point (`sdt_mha_bf16`, the model under `use_bf16`): bf16
// q, k, v and out, f32 logits and sums, rounding where the JAX kernel does
// (ops/attention_kernel.py:81-83 there): the NORMALIZED weights
// w = e / (sum + 1e-30) to bf16 before the value product, whose sums are
// f32, then the output once to bf16.
//
// Its design is Hopper's: one warpgroup (128 threads) owns a tile of 64
// query rows, and both products are `wgmma`, bf16 with f32 accumulation.
// q k^T is one m64nNk16 per 16 dims of D (N = the tile's keys, 16 to 256),
// A (q) from registers, loaded once, B (K) from shared memory; w v is one
// m64n32k16 per 16 keys, A (w) from registers, straight from the q k^T
// accumulators (rows g and g + 8 of a warp, keys 2 t4 and 2 t4 + 1 of each
// 8-key block: the accumulator of 16 keys is the A fragment of their
// k-step), B (V) from shared memory, N-major, in two accumulator chains
// (even and odd 16-key chunks) where registers allow. Each group of
// products is issued back to back and waited for once. K and V tiles come
// in by TMA (`cp.async.bulk.tensor`, a 3-D map over [B, Nk, H*D] with the
// 64-byte swizzle that `wgmma`'s descriptors read), each tile on an
// `mbarrier` of its own, so q k^T starts while V is still in flight; keys
// past Nk are zeros the TMA fills in, and their weights are exactly 0.
// e = exp(min(logit, 80)) is computed as 2^min(s scale log2(e),
// 80 log2(e)) with `ex2.approx` (2 ulp), one multiply, one min and one
// exp a key, the multi-function unit being the scarce one here.
//
// There is no running max, so no sum is ever rescaled, and q k^T is taken
// once on every shape:
// (a) up to 256 keys (every UNet level of the flagship, the 15-slot
//     cross-attention padded to 16): all the keys are one tile, and the
//     row's f32 e stays in the accumulator registers (up to 128 a
//     thread) across all its keys, so the sum is complete before the
//     first weight is rounded, where JAX rounds it: w = bf16(e * (1 /
//     (sum + 1e-30))), the reciprocal taken once a row (an IEEE division
//     a weight cost more than the products);
// (b) more keys (COCO's 784-token level): tiles of 128 keys through a
//     ring of two stages (the next tile's TMA in flight while this one is
//     multiplied); bf16(e) v is accumulated in f32 with the f32 sum of
//     the unrounded e, and the output is divided once at the end. The
//     weights are rounded before the division rather than after it:
//     one bf16 rounding of each weight either way, well inside the
//     2^-7 of the largest output that chip_smoke.py holds it to. (As in
//     the f32 entry, e v is summed unnormalized: a row whose logits reach
//     the clamp, e = 5.5e34, with |v| above ~7 would overflow f32 there.)
// Short queries (16 or 32 rows) would leave most of a 64-row tile idle,
// so a tile packs 4 (or 2) (batch, head) pairs: their keys sit side by
// side in one tile (up to 256), and a row's weights on another pair's
// keys are exactly 0 (a block-diagonal mask). A tile holds 16, 32, 64,
// 128 or 256 keys, one instance each.
//
// Bound of the bf16 entry point on the H100: 4*B*Nq*Nk*H*D operations at
// the bf16 tensor-core rate (989 TFLOP/s; the padded and masked keys are
// the kernel's own choice and not counted) against q, k, v and out moved
// once at 2 bytes a value (3.35 TB/s): every UNet shape is bound by bytes,
// Nq = Nk = 256 with 8 heads included (D = 32 is 64 bytes a row: 8
// operations a byte, the card's balance is ~295).

#include <cuda.h>  // CUtensorMap; the encoder is fetched from the driver
#include <cuda_bf16.h>
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low bits
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kTileRows = 64;    // query rows of a warpgroup's tile
constexpr int kRowBytes = 64;    // a K or V row: 32 bf16
constexpr int kMaxTileKeys = 256;
constexpr int kLongTileKeys = 128;  // design (b)'s tiles

// 80 log2(e): exp(min(x, 80)) = 2^min(x log2(e), 80 log2(e))
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClampLog2 = 80.f * kLog2e;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// a TMA that never lands traps (a launch error) instead of hanging
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

// a [32 dims x rows keys] box of a [B, Nk, H*D] map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int dim, int key, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(dim), "r"(key), "r"(b),
      "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor for rows of 64 bytes in the 64-byte
// swizzle (layout type 2) the TMA writes: 8-row groups 512 bytes apart
// (the stride byte offset); the leading byte offset is not read for a
// K-major operand, nor for an N-major one 32 values wide
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of a wgmma operand across the
// asynchronous product
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r));
}

// s[0 .. N/2) = q (64 x 16, registers) . K^T (N keys, K-major), + s if
// `accumulate`: one instruction over the tile's keys (the accumulator of
// 8-key block b is s[4 b .. 4 b + 3])
template <int N>
struct Qk;
template <>
struct Qk<16> {
  static __device__ __forceinline__ void run(float* d, const uint32_t a[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
  }
};
template <>
struct Qk<32> {
  static __device__ __forceinline__ void run(float* d, const uint32_t a[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
  }
};
template <>
struct Qk<64> {
  static __device__ __forceinline__ void run(float* d, const uint32_t a[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
  }
};
template <>
struct Qk<128> {
  static __device__ __forceinline__ void run(float* d, const uint32_t a[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
  }
};
template <>
struct Qk<256> {
  static __device__ __forceinline__ void run(float* d, const uint32_t a[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
  }
};

// o[16] += w (64 x 16 keys, registers) . V chunk (16 keys x 32, N-major)
__device__ __forceinline__ void wgmma_wv(float o[16], const uint32_t a[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]),
        "+f"(o[5]), "+f"(o[6]), "+f"(o[7]), "+f"(o[8]), "+f"(o[9]),
        "+f"(o[10]), "+f"(o[11]), "+f"(o[12]), "+f"(o[13]), "+f"(o[14]),
        "+f"(o[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// NCH 16-key chunks a tile. pairs (batch, head) pairs share the tile's
// 64 rows (rows_per_pair each) and its keys (kbox each, side by side);
// ntiles > 1 only with pairs == 1 (design (b)).
template <int NCH>
__global__ void __launch_bounds__(128, NCH <= 8 ? 3 : 2)
mha_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const __nv_bfloat16* __restrict__ q,
                      __nv_bfloat16* __restrict__ out, int B, int Nq, int Nk,
                      int H, float scale2, int pairs, int rows_per_pair,
                      int kbox, int kshift, int ntiles) {
  constexpr int kTileBytes = NCH * 16 * kRowBytes;  // a K (or V) tile
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 512 bytes and the TMA wants its box there
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int nst = ntiles > 1 ? 2 : 1;
  const uint32_t bars = base + nst * 2 * kTileBytes;  // K at +16s, V +8
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int HD = H * kHeadDim, npairs = B * H;
  const int pair0 = blockIdx.x * pairs;
  const int row0 = blockIdx.y * kTileRows;  // pairs == 1: the row tile

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(bars + 16 * s);
      mbar_init(bars + 16 * s + 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0: key tile t into stage t % nst (a pair past the last one
  // loads a box wholly outside the map: zeros, its bytes counted)
  auto issue = [&](int t) {
    const int s = t % nst;
    const uint32_t kd = base + s * 2 * kTileBytes, vd = kd + kTileBytes;
    const uint32_t bytes = pairs * kbox * kRowBytes;
    mbar_expect(bars + 16 * s, bytes);
    mbar_expect(bars + 16 * s + 8, bytes);
    for (int p = 0; p < pairs; ++p) {
      const int pr = pair0 + p;
      const int b = pr < npairs ? pr / H : B, h = pr < npairs ? pr % H : 0;
      tma_load(kd + p * kbox * kRowBytes, &tmk, h * kHeadDim, t * kbox, b,
               bars + 16 * s);
      tma_load(vd + p * kbox * kRowBytes, &tmv, h * kHeadDim, t * kbox, b,
               bars + 16 * s + 8);
    }
  };
  if (tid == 0)
    for (int t = 0; t < nst && t < ntiles; ++t) issue(t);

  // this thread's rows of the tile: r = 16 warp + g (+ 8); their pair and
  // their query row, and q as the A fragments of the 2 k-steps over D
  int rpair[2], qrow[2];
  bool rvalid[2];
  const __nv_bfloat16* qp[2];
  __nv_bfloat16* op[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + g + 8 * i;
    rpair[i] = r / rows_per_pair;
    qrow[i] = row0 + r % rows_per_pair;
    const int pr = pair0 + rpair[i];
    rvalid[i] = rpair[i] < pairs && pr < npairs && qrow[i] < Nq;
    const size_t off = rvalid[i] ?
        ((size_t)(pr / H) * Nq + qrow[i]) * HD + (pr % H) * kHeadDim : 0;
    qp[i] = q + off;
    op[i] = out + off;
  }
  uint32_t qa[2][4];
#pragma unroll
  for (int d = 0; d < 2; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i & 1;
      qa[d][i] = rvalid[r] ? *reinterpret_cast<const uint32_t*>(
          qp[r] + 16 * d + 2 * t4 + 8 * (i >> 1)) : 0u;
    }

  // even and odd chunks: two chains of w v products (one at 256 keys,
  // whose 128 accumulators of q k^T leave no room for the second)
  float o[2][16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[0][i] = o[1][i] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // this thread's part of its rows' sums of e
  float s[NCH][8];
  uint32_t w[NCH][4];  // bf16 pairs: the A fragments of w v
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % nst;
    const uint32_t par = (t / nst) & 1;
    const uint32_t kd = base + st * 2 * kTileBytes, vd = kd + kTileBytes;
    // s = q k^T over the tile's keys: every product issued back to back,
    // then one wait (no register of theirs is touched in between)
    mbar_wait(bars + 16 * st, par);
    wg_fence();
#pragma unroll
    for (int d = 0; d < 2; ++d)
      Qk<NCH * 16>::run(&s[0][0], qa[d], desc64(kd + d * 32), d);
    wg_commit_wait();
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) reg_fence(s[j][i]);
    // e = exp(min(scale s, 80)) as 2^min(s scale log2(e), 80 log2(e)),
    // exactly 0 on a padded key or another pair's; element i of chunk j:
    // row i >> 1 & 1, key 16 j + 8 (i >> 2) + 2 t4 + (i & 1) of the tile.
    // A tile of real keys alone (every one but a last partial tile) takes
    // no mask; a chunk wholly past Nk takes no exp
    const int nvalid = pairs == 1 ? Nk - t * kbox : NCH * 16;
    float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [row][chunk parity]
    if (pairs == 1 && nvalid >= NCH * 16) {
#pragma unroll
      for (int j = 0; j < NCH; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[j][i] = ex2(fminf(s[j][i] * scale2, kClampLog2));
          ls[(i >> 1) & 1][j & 1] += s[j][i];
        }
    } else {
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        if (16 * j >= nvalid) {
#pragma unroll
          for (int i = 0; i < 8; ++i) s[j][i] = 0.f;
          continue;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 16 * j + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const int row = (i >> 1) & 1;
          const bool valid = pairs == 1 ? c < nvalid :
              ((c >> kshift) == rpair[row] && (c & (kbox - 1)) < Nk);
          s[j][i] = valid ? ex2(fminf(s[j][i] * scale2, kClampLog2)) : 0.f;
          ls[row][j & 1] += s[j][i];
        }
      }
    }
    l0 += ls[0][0] + ls[0][1];
    l1 += ls[1][0] + ls[1][1];
    float r0 = 1.f, r1 = 1.f;
    if (ntiles == 1) {  // (a): the sums are whole; w = e / (sum + 1e-30)
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, m);
        l1 += __shfl_xor_sync(0xffffffffu, l1, m);
      }
      r0 = 1.f / (l0 + 1e-30f);
      r1 = 1.f / (l1 + 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      w[j][0] = pack_bf16(s[j][0] * r0, s[j][1] * r0);
      w[j][1] = pack_bf16(s[j][2] * r1, s[j][3] * r1);
      w[j][2] = pack_bf16(s[j][4] * r0, s[j][5] * r0);
      w[j][3] = pack_bf16(s[j][6] * r1, s[j][7] * r1);
    }
    // o += w v (in (b), w = e)
    mbar_wait(bars + 16 * st + 8, par);
    wg_fence();
#pragma unroll
    for (int j = 0; j < NCH; ++j)
      wgmma_wv(o[NCH < 16 ? j & 1 : 0], w[j], desc64(vd + j * 16 * kRowBytes));
    wg_commit_wait();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      reg_fence(o[0][i]);
      reg_fence(o[1][i]);
    }
    if (t + nst < ntiles) {
      __syncthreads();  // every warp is done with this stage's K and V
      if (tid == 0) issue(t + nst);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) o[0][i] += o[1][i];
  float inv0 = 1.f, inv1 = 1.f;
  if (ntiles > 1) {  // (b): divide once
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, m);
      l1 += __shfl_xor_sync(0xffffffffu, l1, m);
    }
    inv0 = 1.f / (l0 + 1e-30f);
    inv1 = 1.f / (l1 + 1e-30f);
  }
  // o element 4 n + i: row i >> 1, dims 8 n + 2 t4 (+ 1)
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (rvalid[0])
      *reinterpret_cast<uint32_t*>(op[0] + 8 * n + 2 * t4) =
          pack_bf16(o[0][4 * n] * inv0, o[0][4 * n + 1] * inv0);
    if (rvalid[1])
      *reinterpret_cast<uint32_t*>(op[1] + 8 * n + 2 * t4) =
          pack_bf16(o[0][4 * n + 2] * inv1, o[0][4 * n + 3] * inv1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, Nk, H*32] bf16 as a 3-D map read in boxes of 32 dims x kbox keys,
// swizzled 64 bytes; keys past Nk read as zeros
bool key_map(CUtensorMap* map, const void* x, int B, int Nk, int H, int kbox) {
  EncodeTiled enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * kHeadDim, (cuuint64_t)Nk,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * kHeadDim * 2,
                                 (cuuint64_t)Nk * H * kHeadDim * 2};
  const cuuint32_t box[3] = {kHeadDim, (cuuint32_t)kbox, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NCH>
int launch_mha_bf16(const CUtensorMap& tmk, const CUtensorMap& tmv,
                    const void* q, void* out, int B, int Nq, int Nk, int H,
                    float scale, int pairs, int rows_per_pair, int kbox,
                    int ntiles, cudaStream_t stream) {
  // at most 33,824 bytes (one 256-key stage, or two of 128 keys): under
  // the 48 KB a launch takes without an attribute
  const int tile_bytes = NCH * 16 * kRowBytes;
  const int smem = (ntiles > 1 ? 2 : 1) * 2 * tile_bytes + 1024 + 32;
  const int groups = (B * H + pairs - 1) / pairs;
  const int row_tiles = pairs == 1 ? (Nq + kTileRows - 1) / kTileRows : 1;
  dim3 grid(groups, row_tiles);
  mha_bf16_wgmma_kernel<NCH><<<grid, 128, smem, stream>>>(
      tmk, tmv, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), B, Nq, Nk, H, scale * kLog2e, pairs,
      rows_per_pair, kbox, __builtin_ctz(kbox), ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: 16-byte-aligned contiguous bf16 (the wrapper checks)
extern "C" int sdt_mha_bf16(const void* q, const void* k, const void* v,
                            void* out, int B, int Nq, int Nk, int H, int D,
                            float scale, void* stream) {
  if (D != kHeadDim || B <= 0 || Nq <= 0 || Nk <= 0 || H <= 0 ||
      B > 65535 || H > 65535 || (Nq + kTileRows - 1) / kTileRows > 65535)
    return (int)cudaErrorInvalidValue;
  // a tile's keys: a power of two of 16-key chunks, the TMA box rows; up
  // to 256 keys one tile (a), else tiles of 128 (b)
  int chunks = 1;
  while (chunks * 16 < Nk && chunks * 16 < kMaxTileKeys) chunks *= 2;
  int kbox = chunks * 16, ntiles = 1;
  if (Nk > kMaxTileKeys) {
    kbox = kLongTileKeys;
    chunks = kLongTileKeys / 16;
    ntiles = (Nk + kbox - 1) / kbox;
  }
  // short queries: 4 (or 2) pairs a 64-row tile, their keys side by side
  const int rows_per_pair = Nq <= 16 ? 16 : (Nq <= 32 ? 32 : kTileRows);
  int pairs = ntiles > 1 ? 1 : kTileRows / rows_per_pair;
  while (pairs > 1 && pairs * kbox > kMaxTileKeys) pairs /= 2;
  chunks *= pairs;
  const int rpp = pairs == 1 ? kTileRows : rows_per_pair;
  CUtensorMap tmk, tmv;
  if (!key_map(&tmk, k, B, Nk, H, kbox) || !key_map(&tmv, v, B, Nk, H, kbox))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (chunks) {
    case 1:
      return launch_mha_bf16<1>(tmk, tmv, q, out, B, Nq, Nk, H, scale, pairs,
                                rpp, kbox, ntiles, st);
    case 2:
      return launch_mha_bf16<2>(tmk, tmv, q, out, B, Nq, Nk, H, scale, pairs,
                                rpp, kbox, ntiles, st);
    case 4:
      return launch_mha_bf16<4>(tmk, tmv, q, out, B, Nq, Nk, H, scale, pairs,
                                rpp, kbox, ntiles, st);
    case 8:
      return launch_mha_bf16<8>(tmk, tmv, q, out, B, Nq, Nk, H, scale, pairs,
                                rpp, kbox, ntiles, st);
    case 16:
      return launch_mha_bf16<16>(tmk, tmv, q, out, B, Nq, Nk, H, scale,
                                 pairs, rpp, kbox, ntiles, st);
  }
  return (int)cudaErrorInvalidValue;
}

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
