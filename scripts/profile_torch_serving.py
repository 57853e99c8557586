#!/usr/bin/env python3
"""Where the card's time goes in one `encode` and one `sample` request of
the PyTorch port (flagship SAViDiffusion, MOVi-E 128x128, random weights
from a seed, 2 videos x 6 frames, f32 with TF32 off, or with `--bf16` the
model built with `use_bf16`: bf16 compute, f32 parameters), and in one
training step (`Trainer.train_step` on the config's 32 synthetic 6-frame
clips: forward, backward, clip, Adam).

    python3 scripts/profile_torch_serving.py [--bf16] [--out DIR]

Each request or step runs once to warm up, then once under
`torch.profiler`
(CPU + CUDA activities). Printed per request: the host wall time, the
device busy time (the sum of the device activities: kernels, copies,
memsets, which run on one stream and so do not overlap), the idle share
(1 - busy / wall), the device time and launches of each of the port's
three kernels (mean device time per launch, free of the host launch cost
that CUDA-event timing of back-to-back launches includes at small
shapes), and the kernels with the most device time. The last line is one
JSON object with those numbers. The full `key_averages` tables go under
`--out` (`*_bf16_key_averages.txt` with `--bf16`). It exits non-zero
when a kernel the work runs (REQUIRED) does not appear in the trace
under its name (under `--bf16`, GN's and attention's bf16 instances).

Needs a CUDA card; exits non-zero without one.
"""

import argparse
import json
import os
import sys
import time

KERNELS = {"gn_silu": "gn_silu_kernel", "attention": "mha_clamped",
           "slot_attention": "sa_cluster_kernel"}
# the device names of the bf16 entries' kernels (`--bf16`)
KERNELS_BF16 = {"gn_silu": "gn_silu_kernel<__nv_bfloat16",
                "attention": "mha_clamped_bf16_kernel",
                "slot_attention": "sa_cluster_kernel"}
# the port's kernels each profiled piece of work must show by name
REQUIRED = {"encode": ("slot_attention",),
            "sample": ("gn_silu", "attention"),
            "train_step": tuple(KERNELS)}


def profile(fn, torch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy, by_name = 0.0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + us)
    if busy <= 0:
        # CUPTI tracing is not open to this process: an idle share of 1
        # would be a false reading
        raise SystemExit("torch.profiler recorded no device activity")
    return prof, wall * 1e3, busy / 1e3, by_name


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile")
    ap.add_argument("--bf16", action="store_true",
                    help="the model in bf16 (use_bf16)")
    args = ap.parse_args()
    kernels = KERNELS_BF16 if args.bf16 else KERNELS
    suffix = "_bf16" if args.bf16 else ""
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.serving import build_serving_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    cfg = configs.SAViLDMMoviE128().copy(use_bf16=args.bf16)
    model = build_model(cfg, device="cuda")
    init_random_(model, torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    video = torch.rand(2, cfg.n_sample_frames, *cfg.resolution, 3,
                       generator=gen, device="cuda") * 2 - 1
    encode = build_serving_fn(model, "encode")
    sample = build_serving_fn(model, "sample")
    slots, _ = encode(video)
    data = SyntheticVideoData(cfg, cfg.train_batch_size,
                              num_samples=cfg.train_batch_size)
    trainer = build_method(model, data, cfg)
    batch = next(iter(data.train_loader(0)))

    def train_step():
        model.train()
        trainer.train_step(batch)

    summary = {"device": torch.cuda.get_device_name(0),
               "dtype": "bf16" if args.bf16 else "f32",
               "train_batch": cfg.train_batch_size}
    for name, fn in (("encode", lambda: encode(video)),
                     ("sample", lambda: sample(0, slots)),
                     ("train_step", train_step)):
        prof, wall_ms, busy_ms, by_name = profile(fn, torch)
        with open(os.path.join(args.out,
                               f"{name}{suffix}_key_averages.txt"),
                  "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
        ours = {}
        for kname, pattern in kernels.items():
            hits = [(n, tot) for k, (n, tot) in by_name.items()
                    if pattern in k]
            n = sum(h[0] for h in hits)
            tot = sum(h[1] for h in hits) / 1e3
            ours[kname] = {"launches": n, "device_ms": tot,
                           "mean_us": 1e3 * tot / n if n else None}
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        print(f"{name}{suffix}: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}",
              flush=True)
        for kname, r in ours.items():
            print(f"  {kname}: {r['launches']} launches, "
                  f"{r['device_ms']:.3f} ms device", flush=True)
        for k, (n, tot) in top:
            print(f"  {tot / 1e3:9.3f} ms  x{n:5d}  {k[:90]}", flush=True)
        summary[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "kernels": ours,
            "top": [{"name": k[:120], "launches": n, "device_ms": t / 1e3}
                    for k, (n, t) in top]}
    print(json.dumps(summary), flush=True)
    missing = [(name, k) for name, ks in REQUIRED.items() for k in ks
               if not summary[name]["kernels"][k]["launches"]]
    if missing:
        print(f"kernels not found in the trace: {missing}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
