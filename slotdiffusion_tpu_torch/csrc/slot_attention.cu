// All slot-attention refinement iterations in one kernel, one thread-block
// cluster per item.
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
// k and v arrive in bf16; every product accumulates in f32, and the
// rounding points are the plain version's (`sa_iterations_ref`).
//
// Design (H100: 132 SMs, 227 KB of shared memory a block, clusters of up
// to 16 blocks). `launch_plan` in ops/slot_attention_kernel.py picks the
// cluster size C: the largest whose B clusters the card runs at once (it
// runs 7 clusters of 16 at once, 15 of 8, 30 of 4, 66 of 2: 16 at B = 2, 8
// at B = 12, 2 at B = 32, where a second wave costs more than doubling each
// block's share), the positions P = ceil(N / C) each block owns, whether
// they stay resident in shared memory across the iterations, and the
// shared-memory bytes; this file checks the plan and refuses one it cannot
// run.
//
// - Positions: block r of an item owns positions [r P, (r + 1) P). It
//   computes their logits, the softmax over the slots of each position,
//   the mask, and partial num [16, D], den [16] and (iteration 0) vsum
//   [D], with no exchange: the softmax is local to a position. Its k/v
//   rows stay in shared memory across the iterations where they fit (B = 2:
//   64 positions, 51 KB; B = 12: 128, 102 KB) and are streamed from device
//   memory in double-buffered tiles of 64 (cp.async) every iteration where
//   they do not (B = 32: 512 positions a block).
// - Tensor cores: q . k and bf16(a) . v are mma.sync m16n8k16 bf16 with
//   f32 accumulators. The 16 MMA rows are the slots (S <= 16; a padded
//   slot gets logit -inf, weight 0 and no share of den, num or the mask);
//   D is zero-padded to a multiple of 16 in shared memory, and positions
//   past the block's last one get k = v = 0 and weight 0.
// - Per-slot sums: each block stores its partial num, den and vsum of
//   every column into the block that owns the column (distributed shared
//   memory, a row block per rank); after a cluster barrier, block r adds
//   the partials of its columns [r CW, (r + 1) CW) in rank order (a
//   reduce-scatter by column). No float atomics: two calls on the same
//   inputs give the same bits.
// - Slot update, split by output column: block r computes its columns of
//   q = LN(slots) @ Wq, of the three GRU gates (inputs and recurrent), of
//   w2's output, and its hidden units [r HW, (r + 1) HW) of the MLP, and
//   stores each slice into every other block before the cluster barrier
//   where the next LN or product needs full rows (q, updates, GRU output,
//   hidden, new slots: six barriers an iteration, with no remote read
//   after any of them). These products stay f32-accurate on the tensor
//   cores in 3xTF32 (mma.sync m16n8k8; each f32 operand split into tf32
//   hi + lo, lo*hi + hi*lo + hi*hi), with the weights read from device
//   memory (L2) by the block that owns their columns, a batch of k-steps
//   at a time. When a product has fewer 8-column tiles than warps, the
//   warps split its K and add their partials in warp order
//   (deterministic). LN parameters and the owned biases are staged in
//   shared memory once.
//
// Bound on the H100: per item and iteration 2 * 2 * N * S * D bf16
// tensor-core flops for the two products against k and v read once (2 * N
// * D * 2 bytes) and ~2 * S * (7 D^2 + 2 D M) f32 flops of the slot update:
// at the flagship's shapes a few microseconds of bytes, far below what the
// barriers and the dependent chain of products (LN -> q -> softmax -> num
// -> GRU -> LN -> MLP) take; the design spreads that chain over C SMs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 16;        // MMA row tile: slots held per item
constexpr int kMaxD = 256;
constexpr int kMaxM = 1024;
constexpr int kMaxCluster = 16;
constexpr int kNumTiles = kMaxD / 8 / kWarps;  // num n-tiles a warp owns
constexpr int kMaxMats = 6;       // weight matrices of one product (GRU)
constexpr int kSmemLimit = 232448;
constexpr float kLnEps = 1e-5f;   // torch nn.LayerNorm default

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ inline int cdiv(int x, int m) { return (x + m - 1) / m; }

// Shared-memory layout of one block; `launch_plan` repeats this
// arithmetic in Python, and the entry point checks that the two agree.
struct Layout {
  int Dp, LD, KLD, Mp, MLD, ALD, CW, HW, nbuf;
  int sl, xa, nw, hid, stage, dstage, vstage, scr, denw, den, vs, cst;  // f32
  int q, kv, as;  // bf16
  int total;
};

__host__ __device__ inline Layout make_layout(int D, int M, int C, int tile,
                                              int resident) {
  Layout L;
  L.Dp = round_up(D, 16);  // MMA depth of q . k, width of num
  L.LD = L.Dp + 4;         // f32 rows: fragment reads hit 32 banks
  L.KLD = L.Dp + 8;        // bf16 rows of q, k, v: likewise
  L.Mp = round_up(M, 8);
  L.MLD = L.Mp + 4;
  L.ALD = tile + 8;        // bf16 rows of the attention weights
  L.CW = round_up(cdiv(D, C), 4);  // output columns a block owns
  L.HW = round_up(cdiv(M, C), 4);  // hidden units a block owns
  L.nbuf = resident ? 1 : 2;       // streamed k/v tiles are double-buffered
  int o = 0;
#define SDT_TAKE(field, bytes) \
  L.field = o;                 \
  o += round_up((bytes), 16);
  SDT_TAKE(sl, 4 * kSlots * L.LD)          // current slots, full rows
  SDT_TAKE(xa, 4 * kSlots * L.LD)          // LN output / updates
  SDT_TAKE(nw, 4 * kSlots * L.LD)          // GRU output, full rows
  SDT_TAKE(hid, 4 * kSlots * L.MLD)        // MLP hidden, full rows
  SDT_TAKE(stage, 4 * C * kSlots * L.CW)   // partial num of the owned
                                           // columns, one row block a rank
  SDT_TAKE(dstage, 4 * C * kSlots)         // partial den, a rank each
  SDT_TAKE(vstage, 4 * C * L.CW)           // partial vsum, a rank each
  SDT_TAKE(scr, 4 * kWarps * kMaxMats * 128)  // split-K partials
  SDT_TAKE(denw, 4 * kWarps * kSlots)      // per-warp den
  SDT_TAKE(den, 4 * kSlots)                // the item's den
  SDT_TAKE(vs, 4 * L.CW)                   // vsum of the owned columns
  SDT_TAKE(cst, 4 * (4 * D + 8 * L.CW + L.HW))  // LN params, own biases
  SDT_TAKE(q, 2 * kSlots * L.KLD)
  SDT_TAKE(kv, 2 * L.nbuf * 2 * tile * L.KLD)  // per buffer: k, then v
  SDT_TAKE(as, 2 * kSlots * L.ALD)
#undef SDT_TAKE
  L.total = o;
  return L;
}

struct SaArgs {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float *slots0, *wq, *lnq_g, *lnq_b, *gwi, *gbi, *gwh, *gbh, *lnm_g,
      *lnm_b, *w1, *b1, *w2, *b2;
  float* slots_out;
  float* mask;
  int N, S, D, M, iters, C, P, tile, resident, with_mask, vec_kv;
  float eps, scale;
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

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

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device to shared memory without registers; `bytes` < 16
// fills the rest with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// y[s, :] = LN(x[s, :]) * g + beta for all 16 rows: half a warp per row,
// its values held in registers (D <= 256: 16 a lane)
__device__ void layer_norm_rows(const float* x, float* y, const float* g,
                                const float* beta, int D, int LD) {
  const int s = threadIdx.x / 16, l = threadIdx.x % 16;  // 16 rows
  const float* xr = x + s * LD;
  float v[kMaxD / 16];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxD / 16; ++i) {
    const int d = l + 16 * i;
    v[i] = d < D ? xr[d] : 0.f;
    sum += v[i];
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mu = sum / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxD / 16; ++i) {
    const float t = l + 16 * i < D ? v[i] - mu : 0.f;
    sq += t * t;
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rs = rsqrtf(sq / D + kLnEps);
#pragma unroll
  for (int i = 0; i < kMaxD / 16; ++i) {
    const int d = l + 16 * i;
    if (d < D) y[s * LD + d] = (v[i] - mu) * rs * g[d] + beta[d];
  }
}

// Y[16, ncols] = X[16, K] @ W[K, ncols] for NW weight matrices on each of
// NX inputs (X in shared memory with row stride ldx and zeros up to K
// rounded to 8; W in device memory, row stride ldw, already offset to the
// block's first column), in 3xTF32. Warps take (8-column tile, K split)
// units; `epi(tile, acc)` gets a lane's accumulators acc[m][e]: row
// g + 8 (e >> 1), column 8 tile + 2 t + (e & 1) of matrix m. Every thread
// of the block calls it.
template <int NX, int NW, typename Epi>
__device__ __forceinline__ void products(const float* const (&X)[NX],
                                         int ldx,
                                         const float* const (&W)[NX * NW],
                                         int ldw, int K, int ncols,
                                         float* scr, Epi epi) {
  constexpr int NM = NX * NW;
  const int tiles = cdiv(ncols, 8);
  if (tiles <= 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ks = tiles >= kWarps ? 1 : kWarps / tiles;
  const int ksteps = cdiv(K, 8), per = cdiv(ksteps, ks);
  // k-steps whose weights are loaded into registers at once: one round
  // trip to L2 serves kBatch k-steps
  constexpr int kBatch = NM == 1 ? 12 : 4;
  for (int u = warp; u < tiles * ks; u += kWarps) {
    const int tile = u % tiles, part = u / tiles;
    const int s1 = min(ksteps, (part + 1) * per);
    const int col = tile * 8 + g;
    const bool cok = col < ncols;
    float acc[NM][4];
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
    for (int sb = part * per; sb < s1; sb += kBatch) {
      float bw[kBatch][NM][2];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int k0 = 8 * (sb + q) + t, k1 = k0 + 4;
        const bool ok = cok && sb + q < s1;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          bw[q][m][0] = ok && k0 < K ? __ldg(W[m] + (size_t)k0 * ldw + col)
                                     : 0.f;
          bw[q][m][1] = ok && k1 < K ? __ldg(W[m] + (size_t)k1 * ldw + col)
                                     : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (sb + q >= s1) break;
        const int k0 = 8 * (sb + q) + t, k1 = k0 + 4;
#pragma unroll
        for (int xi = 0; xi < NX; ++xi) {
          const float* x = X[xi];
          uint32_t ah[4], al[4];
          split(x[g * ldx + k0], ah[0], al[0]);
          split(x[(g + 8) * ldx + k0], ah[1], al[1]);
          split(x[g * ldx + k1], ah[2], al[2]);
          split(x[(g + 8) * ldx + k1], ah[3], al[3]);
#pragma unroll
          for (int wi = 0; wi < NW; ++wi) {
            const int m = xi * NW + wi;
            uint32_t bh0, bl0, bh1, bl1;
            split(bw[q][m][0], bh0, bl0);
            split(bw[q][m][1], bh1, bl1);
            mma_tf32(acc[m], al, bh0, bh1);
            mma_tf32(acc[m], ah, bl0, bl1);
            mma_tf32(acc[m], ah, bh0, bh1);
          }
        }
      }
    }
    if (ks == 1) {
      epi(tile, acc);
    } else {
#pragma unroll
      for (int m = 0; m < NM; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          scr[((u * NM + m) * 32 + lane) * 4 + e] = acc[m][e];
    }
  }
  if (ks > 1) {
    __syncthreads();
    if (warp < tiles) {  // sum tile `warp`'s K splits in order
      float acc[NM][4];
#pragma unroll
      for (int m = 0; m < NM; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
      for (int p = 0; p < ks; ++p)
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][e] += scr[(((p * tiles + warp) * NM + m) * 32 + lane) *
                                 4 + e];
      epi(warp, acc);
    }
    __syncthreads();  // the scratch is free again
  }
}

// Store this block's columns [c_lo, c_lo + ncol) of the 16 rows of `buf`
// (row stride ld) into the same place of every other block's copy; the
// cluster barrier that follows makes them visible.
template <typename T>
__device__ void scatter(cg::cluster_group& cluster, T* buf, int ld,
                        int c_lo, int ncol, int rank, int C) {
  const int per = kSlots * ncol, total = per * (C - 1);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int j0 = i / per, r = i % per;
    const int at = (r / ncol) * ld + c_lo + r % ncol;
    cluster.map_shared_rank(buf, j0 + (j0 >= rank))[at] = buf[at];
  }
}

// k/v rows [p0, p0 + cnt) of one item into shared memory (row stride KLD),
// rows [cnt, npad) zeroed; the 16-byte path is asynchronous and commits
// one cp.async group, which the caller waits for
__device__ void load_kv(const SaArgs& a, const __nv_bfloat16* kb,
                        const __nv_bfloat16* vb, int p0, int cnt, int npad,
                        int KLD, __nv_bfloat16* kt, __nv_bfloat16* vt) {
  const int D = a.D;
  if (a.vec_kv) {  // D % 8 == 0, 16-byte aligned: 16-byte async copies
    const int cpr = D / 8;
    for (int i = threadIdx.x; i < npad * cpr; i += kThreads) {
      const int r = i / cpr, c = 8 * (i % cpr);
      const int bytes = r < cnt ? 16 : 0;  // 0: the copy writes zeros
      const size_t off = (size_t)(r < cnt ? p0 + r : p0) * D + c;
      cp_async16(kt + r * KLD + c, kb + off, bytes);
      cp_async16(vt + r * KLD + c, vb + off, bytes);
    }
  } else {  // D even: 4-byte chunks
    const int cpr = D / 2;
    for (int i = threadIdx.x; i < npad * cpr; i += kThreads) {
      const int r = i / cpr, c = 2 * (i % cpr);
      uint32_t kx = 0, vx = 0;
      if (r < cnt) {
        kx = ld32(kb + (size_t)(p0 + r) * D + c);
        vx = ld32(vb + (size_t)(p0 + r) * D + c);
      }
      *reinterpret_cast<uint32_t*>(kt + r * KLD + c) = kx;
      *reinterpret_cast<uint32_t*>(vt + r * KLD + c) = vx;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending committed cp.async groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__global__ void __launch_bounds__(kThreads, 1)
sa_cluster_kernel(const SaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int N = a.N, S = a.S, D = a.D, M = a.M;
  const Layout L = make_layout(D, M, C, a.tile, a.resident);
  const int LD = L.LD, KLD = L.KLD, Dp = L.Dp, CW = L.CW;
  float* sl = reinterpret_cast<float*>(smem + L.sl);
  float* xa = reinterpret_cast<float*>(smem + L.xa);
  float* nw = reinterpret_cast<float*>(smem + L.nw);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* dstage = reinterpret_cast<float*>(smem + L.dstage);
  float* vstage = reinterpret_cast<float*>(smem + L.vstage);
  float* scr = reinterpret_cast<float*>(smem + L.scr);
  float* denw = reinterpret_cast<float*>(smem + L.denw);
  float* den = reinterpret_cast<float*>(smem + L.den);
  float* vs = reinterpret_cast<float*>(smem + L.vs);
  float* lnq_g = reinterpret_cast<float*>(smem + L.cst);
  float* lnq_b = lnq_g + D;
  float* lnm_g = lnq_b + D;
  float* lnm_b = lnm_g + D;
  float* gb = lnm_b + D;     // [6][CW]: bias_ih r, z, n; bias_hh r, z, n
  float* b1o = gb + 6 * CW;  // [HW]
  float* b2o = b1o + L.HW;   // [CW]
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* kv0 = reinterpret_cast<__nv_bfloat16*>(smem + L.kv);
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem + L.as);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // MMA fragment coordinates
  // this block's positions, output columns and hidden units
  const int n_lo = min(N, rank * a.P), n_hi = min(N, n_lo + a.P);
  const int c_lo = min(D, rank * CW), ncol = min(D, c_lo + CW) - c_lo;
  const int h_lo = min(M, rank * L.HW), nhid = min(M, h_lo + L.HW) - h_lo;
  const int ptiles = cdiv(n_hi - n_lo, a.tile);
  const float kNegInf = __int_as_float(0xff800000u);

  // every pad of every buffer is zero
  for (int i = tid; i < L.total / 16; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const float* s0 = a.slots0 + (size_t)b * S * D;
  for (int i = tid; i < S * D; i += kThreads)
    sl[(i / D) * LD + i % D] = s0[i];
  for (int d = tid; d < D; d += kThreads) {
    lnq_g[d] = a.lnq_g[d];
    lnq_b[d] = a.lnq_b[d];
    lnm_g[d] = a.lnm_g[d];
    lnm_b[d] = a.lnm_b[d];
  }
  for (int i = tid; i < 6 * ncol; i += kThreads) {
    const int m = i / ncol, c = i % ncol;
    gb[m * CW + c] = m < 3 ? a.gbi[m * D + c_lo + c]
                           : a.gbh[(m - 3) * D + c_lo + c];
  }
  for (int i = tid; i < nhid; i += kThreads) b1o[i] = a.b1[h_lo + i];
  for (int i = tid; i < ncol; i += kThreads) b2o[i] = a.b2[c_lo + i];
  const __nv_bfloat16* kb = a.k + (size_t)b * N * D;
  const __nv_bfloat16* vb = a.v + (size_t)b * N * D;
  float vacc = 0.f;  // iteration 0: this thread's column tid of vsum
  // this block's columns of each weight matrix
  const float* const Wq[1] = {a.wq + c_lo};
  const float* const Wg[6] = {a.gwi + c_lo, a.gwi + D + c_lo,
                              a.gwi + 2 * D + c_lo, a.gwh + c_lo,
                              a.gwh + D + c_lo, a.gwh + 2 * D + c_lo};
  const float* const W1[1] = {a.w1 + h_lo};
  const float* const W2[1] = {a.w2 + c_lo};
  // every block of the cluster runs and has zeroed its memory before any
  // peer stores into it
  cluster.sync();

  const int tile_elems = 2 * a.tile * KLD;
  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    // the first k/v tile is copied while LN, q and their barrier run
    const bool fetch = !a.resident || it == 0;
    if (fetch && ptiles > 0) {
      const int cnt = min(a.tile, n_hi - n_lo);
      load_kv(a, kb, vb, n_lo, cnt, round_up(cnt, 16), KLD, kv0,
              kv0 + a.tile * KLD);
    }
    // ---- q = bf16(LN(slots) @ Wq): this block's columns, to every block
    layer_norm_rows(sl, xa, lnq_g, lnq_b, D, LD);
    __syncthreads();
    {
      const float* const X[1] = {xa};
      products<1, 1>(X, LD, Wq, D, D, ncol, scr,
                     [&](int tile, const float (&acc)[1][4]) {
#pragma unroll
                       for (int e = 0; e < 4; ++e) {
                         const int col = tile * 8 + 2 * t + (e & 1);
                         if (col < ncol)
                           qb[(g + 8 * (e >> 1)) * KLD + c_lo + col] =
                               __float2bfloat16(acc[0][e]);
                       }
                     });
    }
    __syncthreads();
    scatter(cluster, qb, KLD, c_lo, ncol, rank, C);
    cluster.sync();

    // ---- this block's positions: logits, softmax, mask, partial sums;
    // streamed tiles are double-buffered (tile pt + 1 is copied while
    // tile pt is used)
    float num[kNumTiles][4];
#pragma unroll
    for (int i = 0; i < kNumTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) num[i][e] = 0.f;
    float den_lo = 0.f, den_hi = 0.f;  // slots g and g + 8
    for (int pt = 0; pt < ptiles; ++pt) {
      const int p0 = n_lo + pt * a.tile;
      const int cnt = min(a.tile, n_hi - p0), npad = round_up(cnt, 16);
      const __nv_bfloat16* kt = kv0 + (pt & 1) * tile_elems;
      const __nv_bfloat16* vt = kt + a.tile * KLD;
      if (fetch && pt + 1 < ptiles) {
        const int p1 = p0 + a.tile, cnt1 = min(a.tile, n_hi - p1);
        __nv_bfloat16* kn = kv0 + ((pt + 1) & 1) * tile_elems;
        load_kv(a, kb, vb, p1, cnt1, round_up(cnt1, 16), KLD, kn,
                kn + a.tile * KLD);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (it == 0 && tid < D) {  // four chains, added in a fixed order
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        for (int n = 0; n < cnt; n += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (n + u < cnt) part[u] += __bfloat162float(vt[(n + u) * KLD + tid]);
        vacc += (part[0] + part[1]) + (part[2] + part[3]);
      }
      // logits [16 slots, 8 positions] a warp, then the softmax over the
      // slots of each position in registers (rows g, g + 8 of the 8 lanes
      // that share t)
      for (int nt = warp; nt < npad / 8; nt += kWarps) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* kr = kt + (nt * 8 + g) * KLD + 2 * t;
        for (int kk = 0; kk < Dp; kk += 16) {
          uint32_t af[4];
          af[0] = ld32(qb + g * KLD + kk + 2 * t);
          af[1] = ld32(qb + (g + 8) * KLD + kk + 2 * t);
          af[2] = ld32(qb + g * KLD + kk + 2 * t + 8);
          af[3] = ld32(qb + (g + 8) * KLD + kk + 2 * t + 8);
          mma_bf16(acc, af, ld32(kr + kk), ld32(kr + kk + 8));
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float lo = g < S ? acc[j] * a.scale : kNegInf;
          const float hi = g + 8 < S ? acc[2 + j] * a.scale : kNegInf;
          float mx = fmaxf(lo, hi);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float el = g < S ? expf(lo - mx) : 0.f;
          const float eh = g + 8 < S ? expf(hi - mx) : 0.f;
          float sum = el + eh;
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          const float inv = 1.f / sum;
          const int n = nt * 8 + 2 * t + j;
          const bool valid = n < cnt;
          const float al = valid ? el * inv : 0.f;
          const float ah = valid ? eh * inv : 0.f;
          den_lo += al;
          den_hi += ah;
          as[g * L.ALD + n] = __float2bfloat16(al);
          as[(g + 8) * L.ALD + n] = __float2bfloat16(ah);
          if (last && a.with_mask && valid) {
            float* mrow = a.mask + ((size_t)b * S) * N + p0 + n;
            if (g < S) mrow[(size_t)g * N] = al;
            if (g + 8 < S) mrow[(size_t)(g + 8) * N] = ah;
          }
        }
      }
      __syncthreads();
      // num += bf16(a) v: the warp's 8-column tiles of D
#pragma unroll
      for (int i = 0; i < kNumTiles; ++i) {
        const int dt = warp + kWarps * i;
        if (dt >= Dp / 8) continue;
        const __nv_bfloat16* vc = vt + dt * 8 + g;
        for (int kk = 0; kk < npad; kk += 16) {
          uint32_t af[4];
          af[0] = ld32(as + g * L.ALD + kk + 2 * t);
          af[1] = ld32(as + (g + 8) * L.ALD + kk + 2 * t);
          af[2] = ld32(as + g * L.ALD + kk + 2 * t + 8);
          af[3] = ld32(as + (g + 8) * L.ALD + kk + 2 * t + 8);
          const int r = kk + 2 * t;
          mma_bf16(num[i], af,
                   pack2(vc[r * KLD], vc[(r + 1) * KLD]),
                   pack2(vc[(r + 8) * KLD], vc[(r + 9) * KLD]));
        }
      }
      __syncthreads();  // `as` and this k/v buffer are rewritten next
    }
    // ---- reduce-scatter: each partial goes to the block that owns its
    // column, into the row block of this rank
#pragma unroll
    for (int i = 0; i < kNumTiles; ++i) {
      const int dt = warp + kWarps * i;
      if (dt >= Dp / 8) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = dt * 8 + 2 * t + (e & 1), s = g + 8 * (e >> 1);
        if (c >= D) continue;
        const int j = c / CW;
        cluster.map_shared_rank(stage, j)[(rank * kSlots + s) * CW + c -
                                          j * CW] = num[i][e];
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      den_lo += __shfl_xor_sync(0xffffffffu, den_lo, o);
      den_hi += __shfl_xor_sync(0xffffffffu, den_hi, o);
    }
    if (t == 0) {
      denw[warp * kSlots + g] = den_lo;
      denw[warp * kSlots + g + 8] = den_hi;
    }
    if (it == 0 && tid < D) {
      const int j = tid / CW;
      cluster.map_shared_rank(vstage, j)[rank * CW + tid - j * CW] = vacc;
    }
    __syncthreads();
    if (tid < kSlots) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += denw[w * kSlots + tid];
      for (int j = 0; j < C; ++j)
        cluster.map_shared_rank(dstage, j)[rank * kSlots + tid] = s;
    }
    cluster.sync();

    // ---- the item's sums of this block's columns, in rank order, then
    // the updates of those columns, to every block
    if (tid < kSlots) {
      float s = 0.f;
      for (int j = 0; j < C; ++j) s += dstage[j * kSlots + tid];
      den[tid] = s;
    }
    if (it == 0 && tid < ncol) {
      float s = 0.f;
      for (int j = 0; j < C; ++j) s += vstage[j * CW + tid];
      vs[tid] = s;
    }
    __syncthreads();
    const float neps = (float)N * a.eps;
    for (int i = tid; i < kSlots * ncol; i += kThreads) {
      const int s = i / ncol, c = i % ncol;
      float acc = 0.f;
      for (int j = 0; j < C; ++j) acc += stage[(j * kSlots + s) * CW + c];
      xa[s * LD + c_lo + c] = (acc + a.eps * vs[c]) / (den[s] + neps);
    }
    __syncthreads();
    scatter(cluster, xa, LD, c_lo, ncol, rank, C);
    cluster.sync();

    // ---- GRUCell (gates packed r | z | n), this block's columns
    {
      const float* const X[2] = {xa, sl};
      products<2, 3>(X, LD, Wg, 3 * D, D, ncol, scr,
                     [&](int tile, const float (&acc)[6][4]) {
#pragma unroll
                       for (int e = 0; e < 4; ++e) {
                         const int col = tile * 8 + 2 * t + (e & 1);
                         if (col >= ncol) continue;
                         const int s = g + 8 * (e >> 1), c = c_lo + col;
                         const float r = sigmoidf(
                             (acc[0][e] + gb[col]) +
                             (acc[3][e] + gb[3 * CW + col]));
                         const float z = sigmoidf(
                             (acc[1][e] + gb[CW + col]) +
                             (acc[4][e] + gb[4 * CW + col]));
                         const float n = tanhf(
                             (acc[2][e] + gb[2 * CW + col]) +
                             r * (acc[5][e] + gb[5 * CW + col]));
                         nw[s * LD + c] = (1.f - z) * n + z * sl[s * LD + c];
                       }
                     });
    }
    __syncthreads();
    scatter(cluster, nw, LD, c_lo, ncol, rank, C);
    cluster.sync();

    // ---- residual MLP: hidden units of this block, then its columns
    layer_norm_rows(nw, xa, lnm_g, lnm_b, D, LD);
    __syncthreads();
    {
      const float* const X[1] = {xa};
      products<1, 1>(X, LD, W1, M, D, nhid, scr,
                     [&](int tile, const float (&acc)[1][4]) {
#pragma unroll
                       for (int e = 0; e < 4; ++e) {
                         const int col = tile * 8 + 2 * t + (e & 1);
                         if (col < nhid)
                           hid[(g + 8 * (e >> 1)) * L.MLD + h_lo + col] =
                               fmaxf(acc[0][e] + b1o[col], 0.f);
                       }
                     });
    }
    __syncthreads();
    scatter(cluster, hid, L.MLD, h_lo, nhid, rank, C);
    cluster.sync();
    {
      const float* const X[1] = {hid};
      products<1, 1>(X, L.MLD, W2, D, M, ncol, scr,
                     [&](int tile, const float (&acc)[1][4]) {
#pragma unroll
                       for (int e = 0; e < 4; ++e) {
                         const int col = tile * 8 + 2 * t + (e & 1);
                         if (col >= ncol) continue;
                         const int s = g + 8 * (e >> 1), c = c_lo + col;
                         sl[s * LD + c] =
                             nw[s * LD + c] + (acc[0][e] + b2o[col]);
                       }
                     });
    }
    __syncthreads();
    if (!last) {
      scatter(cluster, sl, LD, c_lo, ncol, rank, C);
      cluster.sync();
    }
  }
  // no peer touches this block's memory after the last barrier
  for (int i = tid; i < S * ncol; i += kThreads) {
    const int s = i / ncol, c = c_lo + i % ncol;
    a.slots_out[((size_t)b * S + s) * D + c] = sl[s * LD + c];
  }
}

std::once_flag g_attr_once;
cudaError_t g_attr_err = cudaSuccess;

// once a process: the dynamic shared memory a block may take, and clusters
// of 16 (a non-portable size)
void set_attributes() {
  g_attr_err = cudaFuncSetAttribute(
      sa_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (g_attr_err == cudaSuccess)
    g_attr_err = cudaFuncSetAttribute(
        sa_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}
std::mutex g_fit_mutex;
std::map<std::pair<int, int>, cudaError_t> g_fit;  // (C, smem) -> verdict

}  // namespace

// The plan (cluster, positions a block, tile, resident, smem_bytes) comes
// from ops/slot_attention_kernel.py:launch_plan; a plan this kernel cannot
// run returns cudaErrorInvalidValue, a cluster that does not fit on the
// card cudaErrorInvalidConfiguration.
extern "C" int sdt_sa_iterations_bf16(
    const void* k, const void* v, const float* slots0, const float* wq,
    const float* lnq_g, const float* lnq_b, const float* gwi, const float* gbi,
    const float* gwh, const float* gbh, const float* lnm_g,
    const float* lnm_b, const float* w1, const float* b1, const float* w2,
    const float* b2, float* slots_out, float* mask, int B, int N, int S,
    int D, int M, int iters, float eps, float scale, int with_mask,
    int cluster, int positions, int tile, int resident, int smem_bytes,
    void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || S > kSlots || D <= 0 || D > kMaxD ||
      D % 2 || M <= 0 || M > kMaxM || iters <= 0)
    return (int)cudaErrorInvalidValue;
  const bool pow2 = cluster > 0 && (cluster & (cluster - 1)) == 0;
  if (!pow2 || cluster > kMaxCluster || positions <= 0 ||
      (long long)positions * cluster < N || tile < 16 || tile % 16 ||
      (resident && tile < positions) ||
      (long long)B * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes != make_layout(D, M, cluster, tile, resident).total ||
      smem_bytes > kSmemLimit)
    return (int)cudaErrorInvalidValue;

  std::call_once(g_attr_once, set_attributes);
  if (g_attr_err != cudaSuccess) return (int)g_attr_err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  {
    std::lock_guard<std::mutex> lock(g_fit_mutex);
    const auto key = std::make_pair(cluster, smem_bytes);
    auto found = g_fit.find(key);
    if (found == g_fit.end()) {
      int fit = 0;
      cudaError_t err = cudaOccupancyMaxActiveClusters(
          &fit, (void*)sa_cluster_kernel, &cfg);
      if (err == cudaSuccess && fit < 1)
        err = cudaErrorInvalidConfiguration;
      found = g_fit.emplace(key, err).first;
    }
    if (found->second != cudaSuccess) return (int)found->second;
  }

  SaArgs a;
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.slots0 = slots0;
  a.wq = wq;
  a.lnq_g = lnq_g;
  a.lnq_b = lnq_b;
  a.gwi = gwi;
  a.gbi = gbi;
  a.gwh = gwh;
  a.gbh = gbh;
  a.lnm_g = lnm_g;
  a.lnm_b = lnm_b;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.slots_out = slots_out;
  a.mask = mask;
  a.N = N;
  a.S = S;
  a.D = D;
  a.M = M;
  a.iters = iters;
  a.C = cluster;
  a.P = positions;
  a.tile = tile;
  a.resident = resident;
  a.with_mask = with_mask;
  a.vec_kv = D % 8 == 0 && ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  a.eps = eps;
  a.scale = scale;
  cudaError_t err = cudaLaunchKernelEx(&cfg, sa_cluster_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks with `smem_bytes` of shared memory
// each the card runs at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int sdt_sa_active_clusters(int cluster, int smem_bytes,
                                      int* out) {
  std::call_once(g_attr_once, set_attributes);
  if (g_attr_err != cudaSuccess) return (int)g_attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)sa_cluster_kernel,
                                             &cfg);
}
