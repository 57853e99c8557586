"""The bf16 entry of the attention kernel (`sdt_mha_bf16`,
`csrc/attention.cu`) on one CUDA card, at every shape the flagship UNet
and COCO's 56x56-latent UNet give it, against its plain version, against
`scaled_dot_product_attention` in bf16 (the library yardstick) and,
optionally, against another tree's build of the same entry (`--parent`,
e.g. the parent commit unpacked with `git archive`), in turns: parent,
this tree, this tree, parent.

    python scripts/bench_torch_attention_bf16.py [--parent DIR ...] [--iters 20]

Per shape: the largest difference from the plain version over the
largest output (held to 2^-7, chip_smoke.py's BF16_TOL), then device ms
per call of the kernel, SDPA, the plain version and the parent's entry,
and the bound: q, k, v and out moved once at 3.35 TB/s, or
4*B*Nq*Nk*H*32 operations at the bf16 tensor-core rate (989 TFLOP/s),
whichever is larger. Device time is CUDA events around the replay of a
CUDA graph of `--iters` back-to-back calls (the median of 5 replays).
Totals: per flagship UNet forward (its 32 calls at B = 12), per training
step's forward (B = 192) and per COCO UNet forward (B = 8). The first
line is `nvidia-smi`'s name and power limit; the last is one JSON
object of every number.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TOL = 2.0 ** -7
UNET = [  # (Nq, Nk, H, calls a UNet forward): the flagship's levels
    (16, 15, 16, 6), (16, 16, 16, 6), (64, 15, 12, 5), (64, 64, 12, 5),
    (256, 15, 8, 5), (256, 256, 8, 5)]
COCO = [  # COCO's 56x56 latents: 49, 196 and 784 tokens, 7 slots
    (49, 7, 16, 6), (49, 49, 16, 6), (196, 7, 12, 5), (196, 196, 12, 5),
    (784, 7, 8, 5), (784, 784, 8, 5)]
CELLS = [("serving", 12, UNET), ("training", 192, UNET), ("coco", 8, COCO)]


def bound_ms(B, Nq, Nk, H):
    hd = 32 * H
    nbytes = 2 * (2 * B * Nq * hd + 2 * B * Nk * hd)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     4.0 * B * Nq * Nk * hd / BF16_FLOPS)


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


def parent_entry(root):
    """The `sdt_mha_bf16` of the tree at `root`, built by that tree's own
    `ops/_cuda.py` into its own `_build/`."""
    path = os.path.join(root, "slotdiffusion_tpu_torch", "ops", "_cuda.py")
    spec = importlib.util.spec_from_file_location("parent_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib().sdt_mha_bf16


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", nargs="*", default=[])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_attention_bf16: no CUDA device")
    from slotdiffusion_tpu_torch.ops import _cuda, attention_kernel as ak
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _cuda.build(verbose=True)
    parents = {os.path.basename(os.path.normpath(d)): parent_entry(d)
               for d in args.parent}
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
            for name, entry in parents.items():
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
            for key in ["ms", "library_ms", "plain_ms", "bound_ms"] + [
                    f"{name}_ms" for name in parents]:
                if key in row:
                    totals.setdefault(cell, {}).setdefault(key, 0.0)
                    totals[cell][key] += calls * row[key]
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
    for cell, t in totals.items():
        print(f"{cell} per UNet forward: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    print(json.dumps(dict(device=smi, rows=rows, totals=totals)),
          flush=True)
    if failed:
        raise SystemExit(f"kernel beyond 2^-7 of the largest output: "
                         f"{failed}")


if __name__ == "__main__":
    main()
