"""The bf16 entries of two of the port's kernels on one CUDA card, at
every shape the flagship UNet and COCO's 56x56-latent UNet give them,
against their plain versions, against one PyTorch call that computes the
same function (the library yardstick) and, optionally, against another
tree's build of the same entry (`--parent`, e.g. the parent commit
unpacked with `git archive`), in turns: parent, this tree, this tree,
parent.

    python scripts/bench_torch_bf16.py attention [--parent DIR ...] \
        [--iters 20]
    python scripts/bench_torch_bf16.py gn [--parent DIR ...] [--iters 20]

`attention` (`sdt_mha_bf16`, `csrc/attention.cu`): per shape the largest
difference from the plain version over the largest output (held to 2^-7,
chip_smoke.py's BF16_TOL), then device ms per call of the kernel,
`scaled_dot_product_attention` in bf16, the plain version and the
parent's entry, and the bound: q, k, v and out moved once at 3.35 TB/s,
or 4*B*Nq*Nk*H*32 operations at the bf16 tensor-core rate (989 TFLOP/s),
whichever is larger.

`gn` (`sdt_group_norm_bf16`, `csrc/group_norm.cu`): per shape the same
error, then ms of the kernel (twice), the parent's bf16 entry, the f32
entry on the same values, `F.group_norm` (+ `F.silu`) in bf16 with a
bf16 affine, the plain version and the bound (x read and y written once
at 3.35 TB/s, or its ~10 f32 operations a value at 67 TFLOP/s), and the
bf16 route. Before the shapes: the
launch floor, an empty kernel with programmatic dependent launch at one
block and at 264 blocks of 128 threads, and the same 264 blocks reading
1 KB and 16 KB each by one bulk copy or by 16-byte loads, in the same
harness; and a check that the f32 entry gives the parent's bits at
every shape (with `--parent`).

Device time is CUDA events around the replay of a CUDA graph of `--iters`
back-to-back calls (the median of 5 replays). Totals: per flagship UNet
forward (its calls at B = 12), per training step's forward (B = 192) and
per COCO UNet forward (B = 8). The first line is `nvidia-smi`'s name and
power limit; the last is one JSON object of every number.
"""

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TOL = 2.0 ** -7
UNET = [  # (Nq, Nk, H, calls a UNet forward): the flagship's levels
    (16, 15, 16, 6), (16, 16, 16, 6), (64, 15, 12, 5), (64, 64, 12, 5),
    (256, 15, 8, 5), (256, 256, 8, 5)]
COCO = [  # COCO's 56x56 latents: 49, 196 and 784 tokens, 7 slots
    (49, 7, 16, 6), (49, 49, 16, 6), (196, 7, 12, 5), (196, 196, 12, 5),
    (784, 7, 8, 5), (784, 784, 8, 5)]
CELLS = [("serving", 12, UNET), ("training", 192, UNET), ("coco", 8, COCO)]
# GN: (C, H, W, SiLU, eps, calls a UNet forward), 32 groups: the 61 calls
# of the flagship's bf16 UNet and of COCO's (`chip_smoke.record_shapes`)
GN_UNET = [
    (1024, 4, 4, True, 1e-5, 2), (128, 16, 16, True, 1e-5, 1),
    (128, 32, 32, True, 1e-5, 8), (256, 16, 16, True, 1e-5, 6),
    (256, 16, 16, False, 1e-6, 5), (256, 32, 32, True, 1e-5, 2),
    (256, 8, 8, True, 1e-5, 1), (384, 16, 16, True, 1e-5, 1),
    (384, 32, 32, True, 1e-5, 1), (384, 4, 4, True, 1e-5, 1),
    (384, 8, 8, True, 1e-5, 6), (384, 8, 8, False, 1e-6, 5),
    (512, 16, 16, True, 1e-5, 1), (512, 4, 4, True, 1e-5, 10),
    (512, 4, 4, False, 1e-6, 6), (640, 16, 16, True, 1e-5, 1),
    (640, 8, 8, True, 1e-5, 1), (768, 8, 8, True, 1e-5, 1),
    (896, 4, 4, True, 1e-5, 1), (896, 8, 8, True, 1e-5, 1)]
GN_COCO = [(C, 7 * H // 4, 7 * W // 4, silu, eps, n)
           for C, H, W, silu, eps, n in GN_UNET]
GN_CELLS = [("serving", 12, GN_UNET), ("training", 192, GN_UNET),
            ("coco", 8, GN_COCO)]
PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// mode 0: nothing; 1: one bulk copy of `bytes` a block into shared memory,
// waited on an mbarrier; 2: the same bytes by 16-byte loads of 128 threads
__global__ void bench_probe_kernel(const uint4* src, int bytes, int mode,
                                   int* sink) {
  __shared__ __align__(128) uint4 buf[1024];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar);
  if (mode == 1 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  uint32_t acc = 0;
  const uint4* p = src + (size_t)blockIdx.x * (bytes / 16);
  if (mode == 1) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(b), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                   "complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(buf)),
                   "l"(p), "r"(bytes), "r"(b) : "memory");
    }
    uint32_t done = 0;
    do {
      asm volatile("{\n.reg .pred q;\n"
                   "mbarrier.try_wait.parity.shared::cta.b64 q, [%1], 0;\n"
                   "selp.u32 %0, 1, 0, q;\n}\n" : "=r"(done) : "r"(b)
                   : "memory");
    } while (!done);
    acc = buf[threadIdx.x % (bytes / 16)].x;
  } else if (mode == 2) {
    for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) acc ^= p[i].x;
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (acc == 0x7f7f7f7fu) *sink = (int)acc;
}
extern "C" int bench_probe(const void* src, int bytes, int mode, int blocks,
                           int threads, void* sink, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, bench_probe_kernel,
                                 (const uint4*)src, bytes, mode, (int*)sink);
}
"""


def bound_ms(B, Nq, Nk, H):
    hd = 32 * H
    nbytes = 2 * (2 * B * Nq * hd + 2 * B * Nk * hd)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     4.0 * B * Nq * Nk * hd / BF16_FLOPS)


def gn_bound_ms(B, C, H, W, silu):
    n = B * C * H * W
    return 1e3 * max((2 * n * 2 + 2 * C * 4) / HBM_BYTES_PER_S,
                     (10 if silu else 6) * n / F32_FLOPS)


def timed_ms(fn, iters, warmup=3, reps=5):
    """Device ms per call: a CUDA graph of `iters` calls, replayed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[reps // 2]


def tree_lib(root):
    """The kernel library of the tree at `root`, built by that tree's own
    `ops/_cuda.py` into its own `_build/`."""
    path = os.path.join(root, "slotdiffusion_tpu_torch", "ops", "_cuda.py")
    name = "bench_cuda_" + hashlib.sha256(root.encode()).hexdigest()[:8]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib()


def probe_lib():
    """`bench_probe(src, bytes, mode, blocks, threads, sink, stream)`,
    built from PROBE_SRC."""
    from slotdiffusion_tpu_torch.ops import _cuda
    tag = hashlib.sha256((PROBE_SRC + " ".join(_cuda.NVCC_FLAGS)).encode()
                         ).hexdigest()[:16]
    out = os.path.join(_cuda.BUILD_ROOT, f"bench-probe-{tag}")
    so = os.path.join(out, "libprobe.so")
    if not os.path.exists(so):
        os.makedirs(out, exist_ok=True)
        src = os.path.join(out, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE_SRC)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", src,
                        "-o", so], check=True)
    lib = ctypes.CDLL(so)
    lib.bench_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.bench_probe.restype = ctypes.c_int
    return lib


def smi_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def add_totals(totals, cell, row, keys, calls):
    for key in keys:
        if row.get(key) is not None:
            totals.setdefault(cell, {}).setdefault(key, 0.0)
            totals[cell][key] += calls * row[key]


def bench_attention(args, parents):
    import torch
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch.ops import _cuda, attention_kernel as ak
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, totals, failed = [], {}, []
    for cell, B, shapes in CELLS:
        for Nq, Nk, H, calls in shapes:
            hd = 32 * H
            q, k, v = (torch.randn(B, n, hd, generator=gen, device="cuda")
                       .to(torch.bfloat16) for n in (Nq, Nk, Nk))
            split = lambda t: t.view(B, t.shape[1], H, -1).transpose(1, 2)
            kern = lambda: ak.fused_mha(q, k, v, H)
            out, ref = kern(), ak.mha_reference(q, k, v, H)
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= TOL * scale:
                failed.append((cell, Nq, Nk, H, err, scale))
            row = dict(cell=cell, B=B, Nq=Nq, Nk=Nk, H=H, calls=calls,
                       err=err, err_of_max=err / scale,
                       bound_ms=bound_ms(B, Nq, Nk, H))
            lib = lambda: F.scaled_dot_product_attention(split(q), split(k),
                                                         split(v))
            olds = {}
            for name, (plib, _) in parents.items():
                entry = plib.sdt_mha_bf16
                pout = torch.empty_like(q)

                def old(entry=entry, pout=pout):
                    _cuda.check(entry(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), pout.data_ptr(), B, Nq,
                                      Nk, H, 32, 32 ** -0.5,
                                      _cuda.stream_ptr(q.device)),
                                name)
                    return pout
                old()
                torch.cuda.synchronize()
                row[f"{name}_err"] = (pout.float() - ref.float()).abs(
                    ).max().item()
                olds[name] = (old, timed_ms(old, args.iters))
            row["ms"] = timed_ms(kern, args.iters)
            row["ms_again"] = timed_ms(kern, args.iters)
            for name, (old, first) in olds.items():
                row[f"{name}_ms"] = (first + timed_ms(old, args.iters)) / 2
            row["library_ms"] = timed_ms(lib, args.iters)
            row["plain_ms"] = timed_ms(
                lambda: ak.mha_reference(q, k, v, H), args.iters)
            rows.append(row)
            add_totals(totals, cell, row, ["ms", "library_ms", "plain_ms",
                                           "bound_ms"] +
                       [f"{name}_ms" for name in parents], calls)
            print(f"{cell} B={B} Nq={Nq} Nk={Nk} H={H} x{calls}: err "
                  f"{err:.3e} of {scale:.3e} ({err / scale:.2e}, tol "
                  f"{TOL:.2e}) | ms kernel {row['ms']:.4f} "
                  f"({row['ms_again']:.4f}), SDPA {row['library_ms']:.4f}, "
                  f"plain {row['plain_ms']:.4f}"
                  + "".join(f", {name} {row[name + '_ms']:.4f}"
                            for name in parents)
                  + f", bound {row['bound_ms']:.4f} "
                  f"(kernel/bound {row['ms'] / row['bound_ms']:.1f})",
                  flush=True)
    return dict(rows=rows, totals=totals), failed


def gn_call(lib, entry, x, w, b, y, G, eps, silu, bulk):
    """One call of the C entry `entry` of `lib`: a run over MAX_GROUP
    values gets the two-pass path's workspace and chunk unless `bulk`
    (the bf16 entry of a tree with the bulk route, csrc/gn_bulk_plan.cuh)
    takes it."""
    import torch
    from slotdiffusion_tpu_torch.ops import _cuda, fused_norm as fn
    B, C, H, W = x.shape
    L = C // G * H * W
    work, chunk = None, 0
    aligned = (x.data_ptr() | y.data_ptr()) % 16 == 0
    if L > fn.MAX_GROUP and not (bulk and fn.bf16_route(L, aligned) ==
                                 "bulk"):
        chunk, count = fn.long_plan(L)
        work = torch.empty(B * G * count * 2, dtype=torch.float32,
                           device=x.device)

    def call():
        _cuda.check(getattr(lib, entry)(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, C,
            H * W, G, eps, silu, None if work is None else work.data_ptr(),
            chunk, _cuda.stream_ptr(x.device)), entry)
        return y
    return call


def bench_gn(args, parents):
    import torch
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch.ops import _cuda, fused_norm as fn
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    stream = _cuda.stream_ptr(dev)
    probe = probe_lib()
    src = torch.zeros(264 * 16384 // 4, dtype=torch.int32, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    floor = {}
    for label, nbytes, mode, blocks, threads in (
            ("empty 1x32", 16, 0, 1, 32), ("empty 264x128", 16, 0, 264, 128),
            ("bulk copy 1 KB x264", 1024, 1, 264, 128),
            ("loads 1 KB x264", 1024, 2, 264, 128),
            ("bulk copy 16 KB x264", 16384, 1, 264, 128),
            ("loads 16 KB x264", 16384, 2, 264, 128)):
        floor[label] = timed_ms(
            lambda: _cuda.check(probe.bench_probe(
                src.data_ptr(), nbytes, mode, blocks, threads,
                sink.data_ptr(), stream), "probe"), args.iters)
    print("launch floor with PDL, ms a call: " + ", ".join(
        f"{k} {v:.5f}" for k, v in floor.items()), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, totals, failed, f32_same = [], {}, [], []
    for cell, B, shapes in GN_CELLS:
        for C, H, W, silu, eps, calls in shapes:
            G, act = 32, "silu" if silu else None
            x = (torch.randn(B, C, H, W, generator=gen, device=dev) * 2 +
                 0.5).to(torch.bfloat16)
            w = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
            b = 0.1 * torch.randn(C, generator=gen, device=dev)
            x32 = x.float()
            wl, bl = w.to(torch.bfloat16), b.to(torch.bfloat16)
            L = C // G * H * W
            route = fn.bf16_route(L, x.data_ptr() % 16 == 0)
            kern = lambda: fn.fused_group_norm(x, w, b, G, eps, act)
            out, ref = kern(), fn.group_norm_reference(x, w, b, G, eps, act)
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            same = torch.equal(out, kern())
            if not (err <= TOL * scale and same):
                failed.append((cell, B, C, H, W, err, scale, same))
            row = dict(cell=cell, B=B, C=C, H=H, W=W, silu=silu, calls=calls,
                       L=L, route=route, err=err, err_of_max=err / scale,
                       bit_identical=same,
                       bound_ms=gn_bound_ms(B, C, H, W, silu))
            f32 = lambda: fn.fused_group_norm(x32, w, b, G, eps, act)
            olds = {}
            for name, (plib, bulk) in parents.items():
                y = torch.empty_like(x)
                old = gn_call(plib, "sdt_group_norm_bf16", x, w, b, y, G,
                              eps, silu, bulk)
                row[f"{name}_err"] = (old().float() - ref.float()).abs(
                    ).max().item()
                y32 = torch.empty_like(x32)
                same32 = torch.equal(gn_call(
                    plib, "sdt_group_norm_f32", x32, w, b, y32, G, eps, silu,
                    False)(), f32())
                row[f"{name}_f32_same_bits"] = same32
                if not same32:
                    f32_same.append((name, cell, B, C, H, W))
                olds[name] = (old, timed_ms(old, args.iters))
            row["ms"] = timed_ms(kern, args.iters)
            row["ms_again"] = timed_ms(kern, args.iters)
            for name, (old, first) in olds.items():
                row[f"{name}_ms"] = (first + timed_ms(old, args.iters)) / 2
            row["f32_ms"] = timed_ms(f32, args.iters)
            lib = (lambda: F.silu(F.group_norm(x, G, wl, bl, eps))) if silu \
                else (lambda: F.group_norm(x, G, wl, bl, eps))
            row["library_ms"] = timed_ms(lib, args.iters)
            row["plain_ms"] = timed_ms(
                lambda: fn.group_norm_reference(x, w, b, G, eps, act),
                args.iters)
            rows.append(row)
            add_totals(totals, cell, row,
                       ["ms", "ms_again", "f32_ms", "library_ms",
                        "plain_ms", "bound_ms"] +
                       [f"{name}_ms" for name in parents], calls)
            totals[cell].setdefault("floor_bound_ms", 0.0)
            totals[cell]["floor_bound_ms"] += calls * max(
                row["bound_ms"], floor["empty 264x128"])
            print(f"{cell} ({B}, {C}, {H}, {W}) silu={silu} x{calls} "
                  f"L={L} {route}: err {err:.3e} of "
                  f"{scale:.3e} ({err / scale:.2e}, tol {TOL:.2e}), "
                  f"{'bit-identical' if same else 'DIFFER'} | ms kernel "
                  f"{row['ms']:.4f} ({row['ms_again']:.4f})"
                  + "".join(f", {name} {row[name + '_ms']:.4f}"
                            for name in parents)
                  + f", f32 {row['f32_ms']:.4f}, library "
                  f"{row['library_ms']:.4f}, plain {row['plain_ms']:.4f}, "
                  f"bound {row['bound_ms']:.4f} (bound/kernel "
                  f"{row['bound_ms'] / row['ms']:.2f})", flush=True)
    if parents:
        print("f32 entry against the parent's: " + (
            "the same bits at every shape" if not f32_same
            else f"DIFFERENT bits at {f32_same}"), flush=True)
        if f32_same:
            failed.append(("f32 bits", f32_same))
    return dict(floor_ms=floor, rows=rows, totals=totals), failed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=("attention", "gn"))
    ap.add_argument("--parent", nargs="*", default=[])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_bf16: no CUDA device")
    from slotdiffusion_tpu_torch.ops import _cuda
    smi = smi_line()
    print(smi, flush=True)
    _cuda.build(verbose=True)
    # each parent's library, and whether its GN has the bf16 bulk route
    parents = {os.path.basename(os.path.normpath(d)): (
        tree_lib(d), os.path.exists(os.path.join(
            d, "slotdiffusion_tpu_torch", "csrc", "gn_bulk_plan.cuh")))
        for d in args.parent}
    res, failed = (bench_attention if args.kernel == "attention"
                   else bench_gn)(args, parents)
    for cell, t in res["totals"].items():
        print(f"{cell} per UNet forward: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    print(json.dumps(dict(device=smi, kernel=args.kernel, **res)),
          flush=True)
    if failed:
        raise SystemExit(f"beyond 2^-7 of the largest output, not "
                         f"deterministic or not the parent's f32 bits: "
                         f"{failed}")


if __name__ == "__main__":
    main()
