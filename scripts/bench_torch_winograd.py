"""Winograd F(2x2, 3x3) kernel of the PyTorch port against the direct
convolution, at the flagship UNet's ResBlock conv shapes, on one CUDA card
(the counterpart of scripts/bench_winograd.py).

    python scripts/bench_torch_winograd.py [--iters 100]

Per shape: the kernel's error against its plain version (bf16 U and V,
f32 sums) and against the f32 direct conv, then the device time per call
of `winograd_conv3x3` (the weight transform included), of its plain
version and of `F.conv2d` in bf16 (channels-last, the library
yardstick), beside the least time the card could take: x, U and y moved
once at 3.35 TB/s, or 8*B*H*W*C*F operations on bf16 operands at
989 TFLOP/s, whichever is larger. Device time is CUDA events around the
replay of a CUDA graph of `--iters` back-to-back calls (no host work
between them; the median of 5 replays); the eager time per call, which
includes the host's launch cost, is in brackets. TF32 is off.
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHAPES = [  # (B, H, W, C, F): the flagship UNet's ResBlock convs
    (32, 32, 32, 128, 128),   # level 0
    (32, 16, 16, 256, 256),   # level 1
    (32, 8, 8, 384, 384),     # level 2
    (32, 4, 4, 512, 512),     # level 3
]
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def bound_ms(B, H, W, C, F):
    nbytes = 2 * (B * H * W * C + 16 * C * F + B * H * W * F)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     8.0 * B * H * W * C * F / BF16_FLOPS)


def timed_ms(fn, iters, warmup=5, reps=5):
    """(device ms, eager ms) per call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # allocate before the capture
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[reps // 2], eager


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=100)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as Fn
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_winograd: no CUDA device")
    from slotdiffusion_tpu_torch.ops.winograd_conv import (
        direct_conv, winograd_conv3x3, winograd_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (B, H, W, C, F) in SHAPES:
        x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.randn(3, 3, C, F, generator=gen, device="cuda") * \
            (9 * C) ** -0.5
        y = winograd_conv3x3(x, w)
        ref = winograd_reference(x, w)
        f32 = direct_conv(x.float(), w)
        err = (y.float() - ref.float()).abs().max().item()
        err32 = (y.float() - f32).abs().max().item()
        scale = f32.abs().max().item()
        xc = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        wc = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t = {name: timed_ms(fn, args.iters) for name, fn in (
            ("kernel", lambda: winograd_conv3x3(x, w)),
            ("plain", lambda: winograd_reference(x, w)),
            ("conv2d-bf16", lambda: Fn.conv2d(xc, wc, padding=1)))}
        print(f"B{B} {H}x{W} C{C}->F{F}: " + " ".join(
            f"{k} {d * 1e3:.1f}us ({e * 1e3:.1f})" for k, (d, e) in
            t.items()) + f" bound {bound_ms(B, H, W, C, F) * 1e3:.1f}us | "
            f"err vs plain {err:.2e}, vs f32 conv {err32:.2e} of "
            f"{scale:.2e}", flush=True)


if __name__ == "__main__":
    main()
