#!/usr/bin/env python3
"""How the slot-attention kernel's launch plan was chosen, on one CUDA card.

    python3 scripts/bench_torch_slot_attention.py

1. How many thread-block clusters of each size (16, 8, 4, 2, 1 blocks of
   256 threads at the flagship's shared memory) the card runs at once
   (cudaOccupancyMaxActiveClusters), beside `ACTIVE_CLUSTERS`, the table
   `launch_plan` decides with.
2. At the flagship's widths (N = 1024, S = 15, D = 192, M = 384, 2
   iterations) and B = 2 (serving), 12 and 32 (training): every cluster
   size, with k/v resident in shared memory where they fit and streamed,
   through the C entry point on bf16 k/v (no wrapper work), device
   microseconds a call (CUDA events around a CUDA graph of 20 calls), its
   error against the plain version, and which plan `launch_plan` takes.
3. The cost of the cluster's exchanges in isolation: a cluster barrier,
   and a store of 16 x 12 floats into each other block followed by a
   barrier (what one of the kernel's five scatters does at B = 2), at
   each cluster size (a small kernel built here with nvcc).

Prints the card's name and power limit first. Needs a CUDA card and nvcc;
exits non-zero without them.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

BARRIER_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// n rounds of (push: 192 floats into every other block) + cluster barrier
__global__ void rounds(int n, int push, unsigned long long* ns) {
  __shared__ float buf[16 * 192];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster.sync();
  const unsigned long long t0 = now();
  for (int i = 0; i < n; ++i) {
    if (push)
      for (int k = threadIdx.x; k < 192 * (C - 1); k += blockDim.x) {
        const int j = k / 192 + (k / 192 >= rank);
        cluster.map_shared_rank(buf, j)[rank * 192 + k % 192] = (float)i;
      }
    cluster.sync();
  }
  if (threadIdx.x == 0) ns[blockIdx.x] = now() - t0;
}

extern "C" int run_rounds(int cluster, int n, int push,
                          unsigned long long* ns) {
  cudaFuncSetAttribute(rounds, cudaFuncAttributeNonPortableClusterSizeAllowed,
                       1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(256);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, rounds, n, push, ns);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}
"""


def main():
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_slot_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import timed
    from slotdiffusion_tpu_torch.ops import _cuda
    from slotdiffusion_tpu_torch.ops import slot_attention_kernel as sak

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    lib = _cuda.lib()
    dev = torch.device("cuda")
    N, S, D, M, iters = 1024, 15, 192, 384, 2

    # 1. clusters the card runs at once
    for C in sak.CLUSTER_SIZES:
        plan = dict(cluster=C, smem_bytes=sak.smem_bytes(
            D, M, C, sak._round_up(-(-N // C), 16), True))
        if plan["smem_bytes"] > sak.SMEM_LIMIT:
            plan["smem_bytes"] = sak.smem_bytes(D, M, C, 64, False)
        print(f"clusters of {C} at once: {sak.active_clusters(plan)} "
              f"(ACTIVE_CLUSTERS: {sak.ACTIVE_CLUSTERS[C]})", flush=True)

    # 2. every plan at the flagship's widths
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    p = {key: rand(*shp) * (shp[0] ** -0.5 if len(shp) == 2 else 0.1)
         for key, shp in {"wq": (D, D), "ln_q_scale": (D,),
                          "ln_q_bias": (D,), "gru_wi": (D, 3 * D),
                          "gru_bi": (3 * D,), "gru_wh": (D, 3 * D),
                          "gru_bh": (3 * D,), "ln_mlp_scale": (D,),
                          "ln_mlp_bias": (D,), "w1": (D, M), "b1": (M,),
                          "w2": (M, D), "b2": (D,)}.items()}
    w = [p[key].contiguous() for key in sak.SA_WEIGHT_KEYS]
    for B in (2, 12, 32):
        k, v, s0 = rand(B, N, D), rand(B, N, D), rand(B, S, D)
        ref = sak.sa_iterations_ref(k, v, s0, p, num_iterations=iters,
                                    eps=1e-8, return_last_attn=True)
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
        out, mask = torch.empty_like(s0), torch.empty(B, S, N, device=dev)
        chosen = sak.launch_plan(B, N, S, D, M)
        for C in sak.CLUSTER_SIZES:
            P = -(-N // C)
            for resident in (True, False):
                tile = sak._round_up(P, 16) if resident else 64
                smem = sak.smem_bytes(D, M, C, tile, resident)
                if smem > sak.SMEM_LIMIT:
                    continue

                def call():
                    err = lib.sdt_sa_iterations_bf16(
                        kb.data_ptr(), vb.data_ptr(), s0.data_ptr(),
                        *[t.data_ptr() for t in w], out.data_ptr(),
                        mask.data_ptr(), B, N, S, D, M, iters, 1e-8,
                        D ** -0.5, 1, C, P, tile, int(resident), smem,
                        _cuda.stream_ptr(dev))
                    _cuda.check(err, "sdt_sa_iterations_bf16")

                call()
                torch.cuda.synchronize()
                err = max((out - ref[0]).abs().max().item(),
                          (mask - ref[1]).abs().max().item())
                ms, _ = timed(call)
                mark = " <- launch_plan" if (C, resident) == (
                    chosen["cluster"], chosen["resident"]) else ""
                kind = "resident" if resident else "streamed"
                print(f"B={B} cluster {C} {kind} k/v: {ms * 1e3:.1f} us a "
                      f"call, max err {err:.1e}{mark}", flush=True)
        plain_ms, _ = timed(lambda: sak.sa_iterations_ref(
            k, v, s0, p, num_iterations=iters, eps=1e-8,
            return_last_attn=True))
        print(f"B={B} plain version: {plain_ms * 1e3:.1f} us a call",
              flush=True)

    # 3. the exchanges alone
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "rounds.cu")
        with open(src, "w") as f:
            f.write(BARRIER_CU)
        so = os.path.join(tmp, "librounds.so")
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", src,
                        "-o", so], check=True)
        rounds = ctypes.CDLL(so)
        ns = torch.zeros(16, dtype=torch.int64, device=dev)
        n = 2000
        for push in (0, 1):
            for C in (16, 8, 4, 2):
                rc = rounds.run_rounds(C, n, push,
                                       ctypes.c_void_p(ns.data_ptr()))
                _cuda.check(rc, "run_rounds")
                what = ("192 floats into each other block + barrier"
                        if push else "cluster barrier")
                print(f"{what}, cluster of {C}: "
                      f"{ns[:C].float().mean().item() / n:.0f} ns",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
