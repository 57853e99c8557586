#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`slotdiffusion_tpu_torch`) on one CUDA
card: build the kernels, hold each against its plain version, serve and
train the flagship SAViDiffusion at full width, and report.

    python3 chip_smoke.py

Phases (one flushed line each, with elapsed seconds):
  1. the device, torch's and scipy's versions, and `nvidia-smi
     --query-gpu=name,power.limit`;
  2. build: nvcc compiles csrc/*.cu (all four kernels) into one library;
  3. every kernel against its plain PyTorch version on the card at the
     shapes the serving path gives it (collected from one denoise call and
     one encode), with its error beside the stated tolerance, a second call
     of slot attention and of GN on the same inputs that must give the
     same bits, slot attention's launch plan (cluster size, positions a
     block, resident or streamed k/v, shared memory), its device
     time per call (CUDA events around a CUDA graph of back-to-back calls)
     and its CUDA-event time over eager calls, the plain
     version's, one PyTorch call's where one computes the same function,
     and the least time the card could take (`bound_ms`); the Winograd
     kernel, which no model calls, at the flagship UNet's four ResBlock
     conv shapes (scripts/bench_winograd.py), each on its own line: the
     weight transform (`kernel_weights`, which must equal its plain
     version bit for bit), the convolution on U (`winograd_conv3x3_u`,
     the kernel's row, against `F.conv2d` with its weights already in
     bf16) and the whole call (`winograd_conv3x3`); then through its own
     entry point with the launch counts set to 0 before and read after;
     ragged edges of each kernel (slot attention: B = 1, S = 16, N that does
     not split evenly over the cluster, D not a multiple of 8 or 16, the
     largest S, D and M it takes); the GN wrapper's host cost a call, split
     into its checks, `empty_like`, the ctypes call and `Function.apply`;
  3b. each kernel's autograd.Function on the card, at the largest of its
     serving shapes (Winograd: the second bench shape): the gradients of
     a random projection of its output through the kernel path against
     the plain path's (the function its backward differentiates), and
     non-zero;
  4. the flagship SAViDiffusion (MOVi-E 128x128, random weights from a
     seeded generator) answers `encode` on 2 videos x 6 frames, `sample`
     (DPM-Solver++, 20 steps, then VQ decode) and one `denoise`, with the
     kernels' launch counts set to 0 before each and read after; its
     outputs are checked for shape, dtype and finiteness, the masks for
     summing to one
     over the slots, and one denoise and one encode against the same
     model run on the CPU (the plain versions);
  5. training the same model: the three model kernels against their
     plain versions, timed and repeated for bit-identity (slot attention,
     GN), at every shape one training step gives them
     (collected from the forward + backward that sizes the batch), and
     their gradients as in 3b at the largest of those shapes; then
     `build_method` -> `Trainer.fit(max_steps=3)` on synthetic 128x128
     6-frame clips, at the config's 32 clips a step if that fits the card
     (else 16, 8 or 4), with the launch counts set to 0 before and read
     after every step; finite losses, a non-zero
     gradient on every trainable parameter outside the frozen VQ-VAE,
     parameters that moved and all three model kernels in every step;
     then a resume from the run's ckpt_last and one more step; and one
     2-clip step's gradients through the kernels against the plain
     versions;
  6. the evaluation path of the same model: `Trainer.validate` with the
     EMA on over 2 batches of 8 synthetic 128x128 6-frame clips with
     masks (losses, FG-ARI, ARI, mIoU, FG-mIoU, mBO; the launches of the
     three model kernels; the live weights bit-identical afterwards);
     the same batches and draws through the plain versions (argmax
     agreement, over all pixels and away from ties, the largest mask
     difference, each metric's and loss's difference); test_seg's
     full-video path (12 frames in chunks of 6, slots carried over);
     test_recon's batch (encode, 20 DPM-Solver++ steps, VQ decode, MSE,
     PSNR, SSIM); slot attention against its plain version at the
     trained 64x64 model's shape (B = 8, N = 4096, S = 6, D = 64,
     M = 128) with its plan, bit-identity and times; wall seconds of
     validate and of the test_recon batch beside the card's power limit;
  7. the flagship in bf16 (`use_bf16=True`, f32 parameters; the knobs
     as above), through the same code as phases 4-6: the GN and
     attention kernels' bf16 entry points against their plain twins (in
     bf16) at every shape of the bf16 serving and training paths, each
     twice on the same inputs (bit-identical), timed beside the library
     call and the bound, the totals beside phase 3's and 5's f32 ones;
     phase 4's requests (slots in bf16; masks, images and the UNet output
     in f32), and one denoise and one encode against the same bf16 model
     through the plain versions; phase 5's training, with the step times
     beside phase 5's; `Trainer.validate` as in phase 6 (its plain-version
     comparison, chunked video, test_recon and res64 shape run in f32
     only). Every request, training step and validate launches GN and
     attention only through their bf16 entries, slot attention through
     its kernel; in phases 4-6 the f32 model never reaches a bf16 entry;
  8. one JSON line listing every kernel (times per serving request;
     `train_ms` / `train_plain_ms`: per training step's forward calls;
     `res64_*`: slot attention at the 64x64 model's shape; the bf16 entry
     points of GN and attention as entries of their own, `"entry"` and
     `"dtype": "bf16"` marking them, with the f32 entry's times beside),
     then the card's name and power limit, then the result line.

It exits non-zero, printing no result line, when there is no CUDA card,
when the port is not beside it, or when any phase fails. Matmuls and
convolutions run in full f32 (TF32 off) so that the comparisons hold the
kernels' f32 arithmetic.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

T0 = time.time()

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12     # f32 outside the tensor cores
BF16_FLOPS = 989e12   # dense bf16 tensor-core rate
TF32_FLOPS = 495e12   # dense TF32 tensor-core rate

# tolerances of kernel vs plain version on the card, and why
TOL = {
    # f32 statistics summed in another order: ~1e-6 on unit-scale outputs
    "gn_silu": 1e-4,
    # f32 logits and sums taken in another order than the matmul's
    "attention": 1e-4,
    # k, v, q and the weights are rounded to bf16 at the same points on
    # both sides; where the f32 value differs in its last bits a rounding
    # can land one bf16 ulp (2^-8) apart in one term of a 192-long sum,
    # which the GRU and MLP carry to slots of magnitude ~10
    "slot_attention": 2e-3,
}
# Winograd, relative to the output's largest magnitude: U and V are
# rounded to bf16 at the same points in the kernel and its plain version,
# whose f32 sums run in another order, so a bf16 output can land one bf16
# ulp apart: 2^-7 of the largest magnitude bounds that ulp. Against the
# f32 direct conv: 3e-2, the JAX package's tests/test_winograd.py class
WINO_TOL, WINO_F32_TOL = 2.0 ** -7, 3e-2
# 3b: the kernel path's gradients against the plain path's, relative to
# the largest gradient: both backwards run the same plain function on the
# same inputs, so only summation order (cuDNN's bf16 conv for Winograd)
GRAD_TOL = {"gn_silu": 1e-5, "attention": 1e-5, "slot_attention": 1e-5,
            "winograd_conv3x3": 1e-2}
# 5: one 2-clip training step's gradients, kernels vs plain versions,
# relative to each parameter's largest gradient (or a hundredth of the
# model's largest, where a gradient is zero in exact arithmetic): the
# kernel path rounds slot attention's k, v, q and weights to bf16
# (2^-8 relative), which moves the slots and every gradient that depends
# on them; measured 1.3e-3 on an H100 (largest at the predictor)
TRAIN_GRAD_TOL = 1e-2
MODEL_KERNELS = ("gn_silu", "attention", "slot_attention")
DETERMINISTIC = ("gn_silu", "slot_attention")  # checked bit for bit
TRAIN_BATCHES = (32, 16, 8, 4)  # clips a step: the config's, then cuts
TRAIN_STEPS = 3
# 7 (bf16): kernel vs plain twin, both bf16 out, relative to the output's
# largest magnitude. GN: the f32 statistics are summed in another order,
# so a value can round one bf16 ulp apart, and one ulp is at most 2^-7 of
# the largest value. Attention: the normalized weights are rounded to
# bf16 at the same point on both sides (JAX's), after f32 sums taken in
# another order, so a weight can round one ulp (2^-8 relative) apart and
# move an output by 2^-8 of a |v|; then the output's own rounding: 2^-7
# of the largest output bounds both at these shapes
BF16_TOL = {"gn_silu_bf16": 2.0 ** -7, "attention_bf16": 2.0 ** -7}
BF16_KERNELS = ("gn_silu_bf16", "attention_bf16", "slot_attention")
# 7: the bf16 model through the kernels vs through the plain versions on
# the card, relative to the output's largest magnitude: the same bf16
# roundings except where a kernel's sum order moves one by an ulp, which
# ~100 bf16 layers carry on (measured on an H100: denoise 2.0e-2, encode
# slots 1.1e-3, masks 2.8e-5)
BF16_PATH_TOL = 5e-2
# 7: the 2-clip step's gradients, kernels vs their plain twins (slot
# attention's with bf16 k/v), as TRAIN_GRAD_TOL; in bf16 every activation
# is rounded to 2^-8 relative, and where a kernel's sum order lands a
# rounding one ulp apart, every gradient behind it moves (measured 2.1e-2
# on an H100, largest at the predictor)
BF16_TRAIN_GRAD_TOL = 1e-1
# 6: validation over EVAL_BATCHES batches of EVAL_BATCH clips, kernels vs
# plain versions (slot attention's bf16 twin). The masks may differ by
# slot attention's error (the largest mask difference is held to
# TOL["slot_attention"]; measured 1.4e-4 to 2.1e-4 on an H100), so a
# pixel's argmax can flip where the plain path's two largest masks are
# within twice that of each other; with random weights most pixels'
# masks sit near 1/15 each. Measured on an H100: the argmax agrees at
# 0.997660 to 0.998336 of the pixels (four runs of this script), 92% of
# the pixels have their two largest masks within ARGMAX_TIE of each other
# (one run), a metric moves by at most 2.7e-4 (four runs). The gates: the
# argmax agrees on every pixel whose two largest plain masks are more
# than ARGMAX_TIE apart; the exact share over all pixels is at least
# ARGMAX_EXACT (the near-ties make that share sensitive to the kernel's
# error, which TOL bounds only loosely); each metric moves by at most
# SEG_METRIC_TOL (about the share of pixels that flip, 7x the largest
# measured move); the losses by 1e-3 relative (f32 sums in another order)
EVAL_BATCH, EVAL_BATCHES = 8, 2
ARGMAX_TIE = 2 * TOL["slot_attention"]
ARGMAX_EXACT = 0.995
LOSS_RTOL = 1e-3
SEG_METRIC_TOL = 2e-3


def log(msg):
    print(f"[{time.time() - T0:8.2f}s] {msg}", flush=True)


def timed(fn, iters=20, warmup=3, reps=5):
    """(device ms, event ms) per call. Device ms: CUDA events around the
    replay of a CUDA graph that holds `iters` calls, over `iters`; the
    median of `reps` replays. The graph launches the calls with no host
    work between them, so this is the card's time for the work. Event ms:
    CUDA events around `iters` back-to-back eager calls, which include the
    host's launch cost whenever the host is slower than the device (small
    shapes)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # compile and allocate before capture
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
    event_ms = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(per_call)[reps // 2], event_ms


def bound_terms(nbytes, f32_ops=0.0, bf16_ops=0.0, tf32_ops=0.0):
    """(ms to move the bytes, ms to do the operations) at the peaks: each
    input read once, each output written once; operations at the rate of
    the unit that does them (`tf32_ops`: TF32 tensor-core products, three
    for each f32-accurate one in the 3xTF32 split)."""
    return (1e3 * nbytes / HBM_BYTES_PER_S,
            1e3 * (f32_ops / F32_FLOPS + bf16_ops / BF16_FLOPS +
                   tf32_ops / TF32_FLOPS))


def record_shapes(model):
    """Forward-pre hooks on `model`'s kernel modules that count its kernel
    calls by shape; -> ({kernel: {shape key: calls}}, hook handles)."""
    from slotdiffusion_tpu_torch.models.blocks import GroupNorm32
    from slotdiffusion_tpu_torch.models.unet import CrossAttention
    shapes = {name: {} for name in MODEL_KERNELS}

    def count(name, key):
        shapes[name][key] = shapes[name].get(key, 0) + 1

    def gn_hook(mod, args):
        if mod.fused:
            count("gn_silu", (tuple(args[0].shape), mod.act, mod.eps,
                              mod.num_groups))

    def attn_hook(mod, args):
        x, ctx = args[0], (args[1] if len(args) > 1 else None)
        nk = x.shape[1] if ctx is None else ctx.shape[1]
        count("attention", (x.shape[0], x.shape[1], nk, mod.num_heads))

    def sa_hook(mod, args):
        count("slot_attention", (args[0].shape[0], args[0].shape[1],
                                 args[1].shape[1],
                                 mod.project_k.out_features,
                                 mod.mlp[1].out_features,
                                 mod.num_iterations))

    handles = [m.register_forward_pre_hook(fn) for m in model.modules()
               for cls, fn in ((GroupNorm32, gn_hook),
                               (CrossAttention, attn_hook),
                               (type(model.savi.slot_attention), sa_hook))
               if isinstance(m, cls)]
    return shapes, handles


def serving_shapes(model, inputs):
    """{kernel: {shape key: calls}} of one encode and one denoise request
    on `inputs` (`serving_inputs`), by `record_shapes`."""
    import torch
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    video, x_t, t_model = inputs
    shapes, handles = record_shapes(model)
    slots, _ = build_serving_fn(model, "encode")(video)
    build_serving_fn(model, "denoise")(x_t, t_model, slots)
    torch.cuda.synchronize()
    for hk in handles:
        hk.remove()
    return shapes


def kernel_cases(shapes, sa_mod, gen, dev):
    """For each kernel call shape in `shapes` (from `record_shapes`), on
    random inputs of that shape: (name, calls, label, kernel call, plain
    call, library call or None, bound terms)."""
    import torch
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch.ops import (attention_kernel, fused_norm,
                                             slot_attention_kernel)
    for (shape, act, eps, G), calls in sorted(shapes["gn_silu"].items(),
                                              key=lambda kv: str(kv[0])):
        C = shape[1]
        xg = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
        wg = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bg = 0.1 * torch.randn(C, generator=gen, device=dev)
        n = xg.numel()
        yield ("gn_silu", calls, f"{tuple(shape)} act={act} eps={eps:g}",
               lambda: fused_norm.fused_group_norm(xg, wg, bg, G, eps, act),
               lambda: fused_norm.group_norm_reference(xg, wg, bg, G, eps,
                                                       act),
               (lambda: F.silu(F.group_norm(xg, G, wg, bg, eps)))
               if act == "silu" else
               (lambda: F.group_norm(xg, G, wg, bg, eps)),
               bound_terms(2 * n * 4 + 2 * C * 4,
                           f32_ops=(10 if act else 6) * n))
    for (Bq, nq, nk, heads), calls in sorted(shapes["attention"].items()):
        hd = heads * attention_kernel.HEAD_DIM
        q = torch.randn(Bq, nq, hd, generator=gen, device=dev)
        k = torch.randn(Bq, nk, hd, generator=gen, device=dev)
        v = torch.randn(Bq, nk, hd, generator=gen, device=dev)
        split = lambda t: t.view(Bq, t.shape[1], heads, -1).transpose(1, 2)
        yield ("attention", calls, f"B={Bq} Nq={nq} Nk={nk} H={heads}",
               lambda: attention_kernel.fused_mha(q, k, v, heads),
               lambda: attention_kernel.mha_reference(q, k, v, heads),
               lambda: F.scaled_dot_product_attention(split(q), split(k),
                                                      split(v)),
               # q k^T and e v on the tensor cores, each f32 product as
               # three TF32 ones (3xTF32)
               bound_terms(4 * (2 * q.numel() + 2 * k.numel()),
                           tf32_ops=3 * 4.0 * Bq * nq * nk * hd))
    p = {key: val.detach().contiguous()
         for key, val in sa_mod.kernel_weights().items()}
    for (Bs, N, S, D, M, iters), calls in sorted(
            shapes["slot_attention"].items()):
        ks = torch.randn(Bs, N, D, generator=gen, device=dev)
        vs = torch.randn(Bs, N, D, generator=gen, device=dev)
        s0 = torch.randn(Bs, S, D, generator=gen, device=dev)
        kw = dict(num_iterations=iters, eps=sa_mod.eps,
                  return_last_attn=True)
        nbytes = (2 * Bs * N * D * 2 + 2 * Bs * S * D * 4 + Bs * S * N * 4 +
                  4 * (D * D + 6 * D * D + 2 * D * M))
        mm = 2.0 * Bs * iters * S
        plan = slot_attention_kernel.launch_plan(Bs, N, S, D, M)
        yield ("slot_attention", calls,
               f"B={Bs} N={N} S={S} D={D} iters={iters} plan {plan} "
               f"({slot_attention_kernel.active_clusters(plan)} such "
               "clusters at once on this card)",
               lambda: slot_attention_kernel.sa_iterations(ks, vs, s0, p,
                                                           **kw),
               lambda: slot_attention_kernel.sa_iterations_ref(ks, vs, s0,
                                                               p, **kw),
               None,
               # q k and a v on the bf16 tensor cores; the Wq, GRU and MLP
               # products as three TF32 products each (3xTF32)
               bound_terms(nbytes, bf16_ops=mm * 2 * N * D,
                           tf32_ops=3 * mm * D * (D + 6 * D + 2 * M)))


def sa_weight_shapes(D, M):
    """Slot attention's weight shapes (SA_WEIGHT_KEYS) at widths D, M."""
    return {"wq": (D, D), "ln_q_scale": (D,), "ln_q_bias": (D,),
            "gru_wi": (D, 3 * D), "gru_bi": (3 * D,), "gru_wh": (D, 3 * D),
            "gru_bh": (3 * D,), "ln_mlp_scale": (D,), "ln_mlp_bias": (D,),
            "w1": (D, M), "b1": (M,), "w2": (M, D), "b2": (D,)}


def gn_host_split(dev, calls=2000):
    """Host microseconds a GN call at a small UNet shape (12 x 512 x 4 x 4,
    where the device needs ~3 us): the wrapper's checks, `empty_like`, the
    stream pointer, the ctypes call alone (launch included), the whole
    wrapper under inference mode (serving) and with a gradient to track
    (`Function.apply`, training); each the host clock over `calls` calls
    ending in a synchronize, so each includes what the card's queue adds
    when the host outruns it."""
    import torch
    from slotdiffusion_tpu_torch.ops import _cuda, fused_norm
    x = torch.randn(12, 512, 4, 4, device=dev)
    w, b = torch.ones(512, device=dev), torch.zeros(512, device=dev)
    y = torch.empty_like(x)
    lib = _cuda.lib()

    def per_call(fn):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e6

    stream = _cuda.stream_ptr(dev)
    wg = w.clone().requires_grad_()
    with torch.inference_mode():
        split = {
            "checks": per_call(lambda: fused_norm.check_inputs(
                x, w, b, 32, "silu")),
            "empty_like": per_call(lambda: torch.empty_like(x)),
            "stream_ptr": per_call(lambda: _cuda.stream_ptr(dev)),
            "ctypes_call": per_call(lambda: lib.sdt_group_norm_f32(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), 12,
                512, 16, 32, 1e-5, 1, stream)),
            "wrapper_inference": per_call(lambda: fused_norm.fused_group_norm(
                x, w, b, 32, 1e-5, "silu")),
        }
    split["wrapper_function_apply"] = per_call(
        lambda: fused_norm.fused_group_norm(x, wg, b, 32, 1e-5, "silu"))
    return split


def max_err(a, b):
    """Largest absolute difference over one output or a tuple of them."""
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))


def record(results, failed, phase, name, calls, label, err, tol, k_t, p_t,
           l_t, terms):
    """Log one shape's check and times; add `calls` of them to the
    kernel's totals in `results`, and the shape to `failed` if the error
    exceeds `tol`."""
    (k_ms, k_ev), (p_ms, p_ev) = k_t, p_t
    l_ms, l_ev = l_t if l_t is not None else (None, None)
    b_ms = max(terms)
    b_by = "bytes" if terms[0] >= terms[1] else "operations"
    ok = err <= tol
    if not ok:
        failed.append(f"{name} {label}")
    lib = "n/a" if l_ms is None else \
        f"{l_ms:.4f} ({l_ev:.4f}), kernel/library {k_ms / l_ms:.3f}"
    log(f"{phase}: {name} {label} x{calls}: max_abs_err {err:.3e} "
        f"(tol {tol:.1e}) {'ok' if ok else 'FAIL'} | device "
        f"(event) ms: kernel {k_ms:.4f} ({k_ev:.4f}), plain "
        f"{p_ms:.4f} ({p_ev:.4f}), library {lib}, bound {b_ms:.4f} "
        f"({b_by})")
    r = results.setdefault(name, dict(err=0.0, ms=0.0, event=0.0,
                                      plain=0.0, lib=0.0, t_bytes=0.0,
                                      t_ops=0.0, has_lib=l_ms is not None))
    r["err"] = max(r["err"], err)
    r["ms"] += calls * k_ms
    r["event"] += calls * k_ev
    r["plain"] += calls * p_ms
    r["lib"] += calls * (l_ms or 0.0)
    r["t_bytes"] += calls * terms[0]
    r["t_ops"] += calls * terms[1]


def same_bits(a, b):
    """Whether two outputs (or tuples of them) are equal bit for bit."""
    import torch
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_kernels(shapes, sa_mod, gen, dev, phase):
    """Every model kernel against its plain version at every shape in
    `shapes`, timed; slot attention and GN also called twice on the same
    inputs, which must give the same bits (neither sums with atomics).
    -> {kernel: totals over those calls}. Raises SystemExit if any
    disagrees."""
    results, failed = {}, []
    for name, calls, label, kern, plain, lib, terms in kernel_cases(
            shapes, sa_mod, gen, dev):
        out = kern()
        if name in DETERMINISTIC:
            same = same_bits(out, kern())
            log(f"{phase}: {name} {label}: two calls on the same inputs "
                f"{'are bit-identical' if same else 'DIFFER'}")
            if not same:
                failed.append(f"{name} {label} not deterministic")
        record(results, failed, phase, name, calls, label,
               max_err(out, plain()), TOL[name], timed(kern),
               timed(plain), None if lib is None else timed(lib), terms)
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")
    for name, r in results.items():
        if r["has_lib"]:
            log(f"{phase}: {name} summed over the calls: kernel "
                f"{r['ms']:.4f} ms, library {r['lib']:.4f} ms (device), "
                f"kernel/library {r['ms'] / r['lib']:.3f}")
    return results


def model_grad_cases(shapes, sa_mod, gen, dev):
    """{kernel: (kernel path, plain path, inputs)} for each model kernel at
    its largest shape in `shapes`; the plain path is the function its
    autograd.Function's backward differentiates."""
    import torch
    from slotdiffusion_tpu_torch.ops import (attention_kernel, fused_norm,
                                             slot_attention_kernel)
    (gshape, gact, geps, gG) = max(shapes["gn_silu"],
                                   key=lambda key: key[0][1])
    C = gshape[1]
    (Bs, N, S, D, M, iters) = max(shapes["slot_attention"])
    (Bq, nq, nk, heads) = max(shapes["attention"])
    hd = heads * attention_kernel.HEAD_DIM
    sa_keys = slot_attention_kernel.SA_WEIGHT_KEYS
    p = sa_mod.kernel_weights()
    sa_kw = dict(num_iterations=iters, eps=sa_mod.eps)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return {
        "gn_silu": (
            lambda x, w, b: fused_norm.fused_group_norm(x, w, b, gG, geps,
                                                        gact),
            lambda x, w, b: fused_norm.group_norm_reference(
                x, w, b, gG, geps, gact),
            [rand(*gshape), 1 + 0.1 * rand(C), 0.1 * rand(C)]),
        "attention": (
            lambda q, k, v: attention_kernel.fused_mha(q, k, v, heads),
            lambda q, k, v: attention_kernel.mha_reference(q, k, v, heads),
            [rand(Bq, n, hd) for n in (nq, nk, nk)]),
        "slot_attention": (
            lambda k, v, s0, *w: slot_attention_kernel.sa_iterations(
                k, v, s0, dict(zip(sa_keys, w)), **sa_kw),
            lambda k, v, s0, *w: slot_attention_kernel.sa_iterations_ref(
                k, v, s0, dict(zip(sa_keys, w)), kv_dtype=torch.float32,
                **sa_kw),
            [rand(Bs, N, D), rand(Bs, N, D), rand(Bs, S, D)] +
            [p[key].detach().contiguous() for key in sa_keys]),
    }


def check_grads(cases, gen, dev, phase):
    """For each (kernel path, plain path, inputs) of `cases`: the gradients
    of a random projection of the output through both paths agree within
    GRAD_TOL of the largest, and the kernel path's are non-zero. Raises
    SystemExit otherwise."""
    import torch

    def grads_of(fn, inputs, proj):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out = out[0] if isinstance(out, tuple) else out
        return torch.autograd.grad((out.float() * proj).sum(), leaves)

    failed = []
    for name, (kern_fn, plain_fn, inputs) in cases.items():
        with torch.no_grad():
            out_shape = plain_fn(*inputs).shape
        proj = torch.randn(out_shape, generator=gen, device=dev)
        gk = grads_of(kern_fn, inputs, proj)
        gp = grads_of(plain_fn, inputs, proj)
        scale = max(g.abs().max().item() for g in gp)
        rel = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(gk, gp)) / scale
        zero = [i for i, g in enumerate(gk) if not g.abs().max() > 0]
        ok = rel <= GRAD_TOL[name] and not zero
        log(f"{phase}: {name} gradients at {tuple(inputs[0].shape)}, "
            f"kernel path vs plain path: max err {rel:.2e} of the largest "
            f"gradient {scale:.2e} (tol {GRAD_TOL[name]:.0e}); zero "
            f"gradients at inputs {zero} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} gradients")
    if failed:
        raise SystemExit(f"gradients of the kernel paths are wrong: "
                         f"{failed}")


@contextlib.contextmanager
def plain_versions(f32_slot_attention):
    """Within the block the model's three kernel call sites take their
    plain versions: GN and attention their f32 formulas, slot attention
    its plain twin with bf16 k/v (the function phase 3 holds the kernel
    against) or, with `f32_slot_attention`, the f32 formula (the JAX
    model's own off-TPU computation). Raises SystemExit if a kernel
    launches in the block."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.models import blocks, slot_attention, unet
    from slotdiffusion_tpu_torch.ops import (attention_kernel, fused_norm,
                                             slot_attention_kernel)
    sa_ref = slot_attention_kernel.sa_iterations_ref
    plain = {
        (blocks, "fused_group_norm"): fused_norm.group_norm_reference,
        (unet, "fused_mha"): attention_kernel.mha_reference,
        (slot_attention, "sa_iterations"):
            (lambda *a, kv_dtype=None, **kw: sa_ref(
                *a, kv_dtype=torch.float32, **kw))
            if f32_slot_attention else sa_ref}
    saved = {key: getattr(*key) for key in plain}
    try:
        for (mod, attr), fn in plain.items():
            setattr(mod, attr, fn)
        ops.reset_launch_counts()
        yield
        torch.cuda.synchronize()
        if any(ops.launch_counts().values()):
            raise SystemExit("the plain path launched a kernel")
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


class StepReport:
    """A trainer's logger: per step, the kernels' launches since the last
    reset (then reset), the peak memory and the metrics."""

    def __init__(self, phase):
        self.phase = phase
        self.steps = []

    def log(self, record, step):
        import torch
        from slotdiffusion_tpu_torch import ops
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
        self.steps.append(dict(record, launches=counts))
        log(f"{self.phase}: step {step}: denoise_loss "
            f"{record['train/denoise_loss']:.5f}, grad norm "
            f"{record.get('train/grad_norm', float('nan')):.4g}, lr "
            f"{record.get('lr', float('nan')):.3g}, "
            f"{record['step_seconds']:.3f} s (host clock), max "
            f"allocated {peak:.2f} GiB, launches {counts}")


def two_clip_grads(model, cfg, dev, tol, phase, f32_slot_attention=True):
    """One 2-clip step's gradients through the kernels and through the
    plain versions (`plain_versions`: by default slot attention's f32
    formula, the JAX model's own off-TPU computation), the same generator
    state, dropout off (eval mode): each parameter's largest error
    relative to its largest gradient (or a hundredth of the model's
    largest, where a gradient is zero in exact arithmetic) within `tol`.
    Raises SystemExit otherwise."""
    import torch
    T, (H, W) = cfg.n_sample_frames, cfg.resolution

    def step_grads():
        model.eval()
        model.zero_grad(set_to_none=True)
        g = torch.Generator(device=dev).manual_seed(7)
        img = torch.rand(2, T, H, W, 3, generator=g, device=dev) * 2 - 1
        _, losses = model.compute_losses({"img": img}, g)
        losses["denoise_loss"].backward()
        return losses["denoise_loss"].item(), {
            n: p.grad.clone() for n, p in model.named_parameters()
            if p.requires_grad}

    loss_k, grads_k = step_grads()
    with plain_versions(f32_slot_attention):
        loss_p, grads_p = step_grads()
    model.zero_grad(set_to_none=True)
    floor = 1e-2 * max(g.abs().max().item() for g in grads_p.values())
    worst = max((((grads_k[n] - g).abs().max() /
                  max(g.abs().max().item(), floor)).item(), n)
                for n, g in grads_p.items())
    log(f"{phase}: 2-clip step, kernels vs plain versions: loss "
        f"{loss_k:.6f} vs {loss_p:.6f}; largest gradient error {worst[0]:.2e}"
        f" of its parameter's scale at {worst[1]} (tol {tol:.0e})")
    if not worst[0] <= tol:
        raise SystemExit("training gradients through the kernels disagree "
                         "with the plain versions'")


def path_kernels(bf16):
    """The kernels a model of the dtype must launch: GN's and attention's
    entry of that dtype, and slot attention's kernel."""
    return BF16_KERNELS if bf16 else MODEL_KERNELS


def check_launches(counts, what, bf16, need=None):
    """`counts` went through each kernel of `need` (by default all of
    `path_kernels(bf16)`) and never through GN's or attention's entry of
    the other dtype. Raises SystemExit otherwise."""
    need = path_kernels(bf16) if need is None else need
    other = path_kernels(not bf16)[:2]
    idle = [k for k in need if counts[k] == 0]
    wrong = [k for k in other if counts[k]]
    if idle or wrong:
        raise SystemExit(f"{what} launched none of {idle}, or the other "
                         f"dtype's entries {wrong}: {counts}")


def serving_inputs(cfg, dev):
    """The serving requests' inputs, from a seeded generator: 2 videos of
    the clip's frames, a noisy latent per frame and its timestep."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    B, T, (H, W) = 2, cfg.n_sample_frames, cfg.resolution
    h, w = cfg.dec_dict["resolution"]
    return (torch.rand(B, T, H, W, 3, generator=g, device=dev) * 2 - 1,
            torch.randn(B * T, h, w, 3, generator=g, device=dev),
            torch.full((B * T,), 500.0, device=dev))


def serve(cfg, model, inputs, phase, f32_seconds=None):
    """The serving path of the built `model` through the port's entry
    points: one `encode`, `sample` and `denoise` request on `inputs`
    (`serving_inputs`), each with the launch counts set to 0 just before
    it and read just after. Checks each output's shape, dtype (slots in
    the compute dtype, the rest f32) and finiteness, that the masks sum
    to 1 over the slots and that each request launched its kernels
    (`check_launches`: encode slot attention, sample and denoise GN and
    attention). -> ({request: {kernel: launches}}, {request: host
    seconds}, slots)."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    video, x_t, t_model = inputs
    B, T, (H, W) = *video.shape[:2], cfg.resolution
    S, D = cfg.slot_dict["num_slots"], cfg.slot_dict["slot_size"]
    f32 = torch.float32
    want = {"slots": ((B, T, S, D), torch.bfloat16 if cfg.use_bf16 else f32),
            "masks": ((B, T, S, H, W), f32),
            "sample": ((B, T, H, W, 3), f32),
            "denoise": (tuple(x_t.shape), f32)}
    encode, sample, denoise = (build_serving_fn(model, s)
                               for s in ("encode", "sample", "denoise"))
    kernels = path_kernels(cfg.use_bf16)
    per_surface, seconds, slots = {}, {}, None
    for name, fn in (("encode", lambda: encode(video)),
                     ("sample", lambda: sample(0, slots)),
                     ("denoise", lambda: denoise(x_t, t_model, slots))):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        per_surface[name] = counts = ops.launch_counts()
        outs = dict(zip(("slots", "masks"), out)) if name == "encode" \
            else {name: out}
        log(f"{phase}: {name} in {seconds[name]:.2f}s" + (
            f" (f32, phase 4: {f32_seconds[name]:.2f}s)" if f32_seconds
            else "") + " -> " + ", ".join(
                f"{k} {tuple(v.shape)} {v.dtype}" for k, v in outs.items())
            + f"; launches {counts}")
        for k, v in outs.items():
            if (tuple(v.shape), v.dtype) != want[k] or \
                    not torch.isfinite(v.float()).all():
                raise SystemExit(f"{phase}: {name}: {k} is {v.dtype} "
                                 f"{tuple(v.shape)}, not {want[k]}, or "
                                 "has non-finite values")
        if name == "encode":
            slots = outs["slots"]
            msum = (outs["masks"].sum(2) - 1).abs().max().item()
            if msum > 1e-4:
                raise SystemExit(f"{phase}: masks do not sum to 1 over "
                                 f"the slots ({msum:.2e})")
        check_launches(counts, f"{phase}: {name}", cfg.use_bf16,
                       kernels[2:] if name == "encode" else kernels[:2])
    return per_surface, seconds, slots


def train(cfg, model, dev, gen, phase, f32_step_seconds=None):
    """Phases 5 and 7: hold the kernels of the model's dtype against their
    plain versions at the shapes of a training step, then train the built
    flagship `model` through the port's entry points; -> ({kernel:
    launches} over the Trainer's steps, {kernel: totals over one step's
    forward calls}, the host seconds of each Trainer step)."""
    import gc
    import tempfile

    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method

    T, (H, W) = cfg.n_sample_frames, cfg.resolution
    gib = 2.0 ** 30
    total_mem = torch.cuda.get_device_properties(0).total_memory
    param_bytes = sum(p.numel() * 4 for p in model.parameters()
                      if p.requires_grad)

    def probe(bs):
        """Peak bytes of one forward + backward at `bs` clips; `shapes`
        then holds its kernel calls."""
        for calls in shapes.values():
            calls.clear()
        model.train()
        torch.cuda.reset_peak_memory_stats()
        img = torch.rand(bs, T, H, W, 3, device=dev) * 2 - 1
        g = torch.Generator(device=dev).manual_seed(0)
        _, losses = model.compute_losses({"img": img}, g)
        losses["denoise_loss"].backward()
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    model.dm_decoder.vae.requires_grad_(False)
    shapes, handles = record_shapes(model)
    batch = None
    for bs in TRAIN_BATCHES:
        try:
            peak = probe(bs)
        except torch.cuda.OutOfMemoryError:
            peak = None
        model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
        # Adam adds two moments per trainable parameter to the peak
        fits = peak is not None and \
            peak + 2 * param_bytes + 2 * gib < total_mem
        log(f"{phase}: {bs} clips a step: peak "
            f"{'OOM' if peak is None else f'{peak / gib:.2f} GiB'} + Adam "
            f"{2 * param_bytes / gib:.2f} GiB of {total_mem / gib:.1f} GiB"
            f" -> {'fits' if fits else 'does not fit'}")
        if fits:
            batch = bs
            break
    for hk in handles:
        hk.remove()
    if batch is None:
        raise SystemExit("no training batch fits the card")
    cut = "" if batch == cfg.train_batch_size else \
        f" (cut from the config's {cfg.train_batch_size})"
    log(f"{phase}: training at {batch} clips x {T} frames a step{cut}")

    # the kernels and their gradients at this training step's shapes
    sa_mod = model.savi.slot_attention
    if cfg.use_bf16:
        train_results = check_bf16_kernels(shapes, gen, dev,
                                           f"{phase} (training shapes)")
    else:
        train_results = check_kernels(shapes, sa_mod, gen, dev, phase)
        check_grads(model_grad_cases(shapes, sa_mod, gen, dev), gen, dev,
                    phase)
    gc.collect()
    torch.cuda.empty_cache()

    # a log line every step; ckpt_last once per epoch of 4 steps (the
    # config's 0.1 of an epoch would write it after every step here)
    tcfg = cfg.copy(print_iter=1, save_interval=1.0)
    data = SyntheticVideoData(tcfg, batch, num_samples=4 * batch, seed=0)
    got_grad = {}

    def note_grad(name):
        def hook(p):
            seen = (p.grad != 0).any()
            got_grad[name] = got_grad[name] | seen if name in got_grad \
                else seen
        return hook

    trainable = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
    hooks = [p.register_post_accumulate_grad_hook(note_grad(n))
             for n, p in trainable]
    start = {n: p.detach().clone() for n, p in trainable}

    totals = dict.fromkeys(ops.launch_counts(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = build_method(model, data, tcfg,
                               ckp_path=os.path.join(tmp, "run"))
        trainer.logger = report = StepReport(phase)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.time()
        trainer.fit(max_steps=TRAIN_STEPS)
        fit_s = time.time() - t0
        steps = [st["step_seconds"] for st in report.steps]
        log(f"{phase}: Trainer.fit(max_steps={TRAIN_STEPS}) took "
            f"{fit_s:.1f}s (host clock, ckpt_last included), steps " +
            " ".join(f"{x:.3f}" for x in steps) + " s" + (
                " (f32, phase 5: " + " ".join(
                    f"{x:.3f}" for x in f32_step_seconds) + " s)"
                if f32_step_seconds else "") + ", max allocated "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
        for hk in hooks:
            hk.remove()
        for st in report.steps:
            for k, n in st["launches"].items():
                totals[k] += n
        losses = [st["train/denoise_loss"] for st in report.steps]
        if len(losses) != TRAIN_STEPS or not all(
                map(math.isfinite, losses)):
            raise SystemExit(f"training losses {losses}")
        for st in report.steps:
            check_launches(st["launches"], f"{phase}: a training step",
                           cfg.use_bf16)
        no_grad = [n for n, _ in trainable
                   if n not in got_grad or not bool(got_grad[n])]
        if no_grad:
            raise SystemExit(f"{len(no_grad)} trainable parameters got no "
                             f"gradient, e.g. {no_grad[:5]}")
        still = [n for n, p in trainable if torch.equal(p, start[n])]
        if still:
            raise SystemExit(f"{len(still)} parameters did not move, e.g. "
                             f"{still[:5]}")
        # master weights and Adam's moments stay f32 in either dtype
        moments = [v for st in trainer.optimizer.adam.state.values()
                   for v in st.values() if torch.is_tensor(v) and v.dim()]
        if any(p.dtype != torch.float32 for _, p in trainable) or \
                not moments or \
                any(v.dtype != torch.float32 for v in moments):
            raise SystemExit("a parameter or an Adam moment is not f32")
        log(f"{phase}: {len(trainable)} trainable tensors outside the "
            f"VQ-VAE all got non-zero gradients and moved; they and "
            f"Adam's moments are f32")
        del moments
        del start
        ckpt = os.path.join(tmp, "run", "ckpt_last.pt")
        del trainer
        gc.collect()
        # no checkpoint directory: the resumed run writes no second file
        resumed = build_method(model, data, tcfg)
        resumed.logger = report
        last = resumed.fit(max_steps=TRAIN_STEPS + 1, resume_from=ckpt)
        if resumed.step != TRAIN_STEPS + 1 or \
                not math.isfinite(last["train/denoise_loss"]):
            raise SystemExit(f"resume from {ckpt} failed: {last}")
        for k, n in report.steps[-1]["launches"].items():
            totals[k] += n
        size = os.path.getsize(ckpt) / gib
        log(f"{phase}: resumed from ckpt_last ({size:.2f} GiB) at step "
            f"{TRAIN_STEPS}, took step {resumed.step}")
        del resumed
    gc.collect()
    torch.cuda.empty_cache()

    # one 2-clip step's gradients through the kernels and through the plain
    # versions, the same generator state, dropout off (eval mode); in f32
    # slot attention's plain version is the JAX model's own off-TPU
    # computation (f32), in bf16 its twin with bf16 k/v: there the f32
    # formula's slots would move every rounding behind them
    if cfg.use_bf16:
        two_clip_grads(model, cfg, dev, BF16_TRAIN_GRAD_TOL, phase,
                       f32_slot_attention=False)
    else:
        two_clip_grads(model, cfg, dev, TRAIN_GRAD_TOL, phase)
    return totals, train_results, steps


def evaluate(cfg, model, dev, gen, smi, phase):
    """Phases 6 and 7: the evaluation path of the built flagship `model`;
    -> ({path: {kernel: launches}}, {kernel: totals} of slot attention at
    the res64 model's shape). In bf16 (phase 7) `Trainer.validate` alone:
    the bf16 model's plain-version check is `bf16_vs_plain`, and the
    chunked video, test_recon and the res64 shape run in f32 only."""
    import gc

    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.data.synthetic import (SyntheticVideoData,
                                                        SyntheticVideoDataset)
    from slotdiffusion_tpu_torch.methods.build import (build_method,
                                                       seg_metrics_fn)
    from slotdiffusion_tpu_torch.methods.inference import chunked_video_apply
    from slotdiffusion_tpu_torch.models import init_random_
    from slotdiffusion_tpu_torch.models.slot_attention import SlotAttention
    from slotdiffusion_tpu_torch.ops import metrics as M

    per_path = {}
    B, T = EVAL_BATCH, cfg.n_sample_frames
    ecfg = cfg.copy(use_ema=True, val_batch_size=B)
    data = SyntheticVideoData(ecfg, B, num_samples=B, seed=0,
                              val_samples=EVAL_BATCHES * B)
    trainer = build_method(model, data, ecfg)
    # the shadow starts as a copy of the live weights: move it (seeded,
    # 1e-3 relative) so that the EMA pass computes something else
    with torch.no_grad():
        for s in trainer.ema.shadow.values():
            s.mul_(1 + 1e-3 * torch.randn(s.shape, generator=gen,
                                          device=dev))
    captured = []

    def capture(batch, out):
        captured.append(out["masks"].clone())
        return seg_metrics_fn(batch, out)

    trainer.host_metrics_fn = capture
    live = {k: v.clone() for k, v in model.state_dict().items()}

    # 1. Trainer.validate through the kernels
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.time()
    res_k = trainer.validate()
    torch.cuda.synchronize()
    val_s = time.time() - t0
    key = "bf16_validate" if cfg.use_bf16 else "validate"
    per_path[key] = ops.launch_counts()
    log(f"{phase}: Trainer.validate over {EVAL_BATCHES} batches of {B} "
        f"synthetic {cfg.resolution[0]}x{cfg.resolution[1]} clips x {T} "
        f"frames, EMA on: {val_s:.3f} s wall ({val_s / EVAL_BATCHES:.3f} s "
        f"a batch, host metrics included) on {smi}; launches "
        f"{per_path[key]}")
    log(f"{phase}: " + ", ".join(f"{k} {v:.6f}"
                                  for k, v in res_k.items()))
    want = {f"val/{k}" for k in ("denoise_loss", "denoise_loss_ema", "ari",
                                 "fari", "miou", "fmiou", "mbo")}
    if set(res_k) != want or not all(map(math.isfinite, res_k.values())):
        raise SystemExit(f"validate gave {res_k}")
    if not all(-1.0 <= res_k[k] <= 1.0 for k in ("val/ari", "val/fari")):
        raise SystemExit(f"ARI outside [-1, 1]: {res_k}")
    check_launches(per_path[key], f"{phase}: validate", cfg.use_bf16)
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, live[k])]
    if moved:
        raise SystemExit(f"validate left {len(moved)} tensors changed, "
                         f"e.g. {moved[:3]}")
    log(f"{phase}: the live state_dict is bit-identical after validate "
        "(the EMA swap restored it)")
    if cfg.use_bf16:
        return per_path, {}

    # 2. the same batches (and draws) through the plain versions
    kernel_masks, captured[:] = list(captured), []
    with plain_versions(f32_slot_attention=False):
        res_p = trainer.validate()
    plain_masks = list(captured)
    # the argmax must agree wherever the plain path's two largest masks
    # are more than ARGMAX_TIE apart
    same_t = torch.zeros(T, device=dev)
    n_px = n_tie = n_miss = 0
    for km, pm in zip(kernel_masks, plain_masks):
        same = km.argmax(2) == pm.argmax(2)
        top2 = pm.topk(2, dim=2).values
        clear = top2[:, :, 0] - top2[:, :, 1] > ARGMAX_TIE
        same_t += same.float().sum((0, 2, 3))
        n_px += same.numel()
        n_tie += (~clear).sum().item()
        n_miss += (clear & ~same).sum().item()
    same_t /= n_px // T
    exact = same_t.mean().item()
    mdiff = max((a - b).abs().max().item()
                for a, b in zip(kernel_masks, plain_masks))
    ok = exact >= ARGMAX_EXACT and n_miss == 0 and \
        mdiff <= TOL["slot_attention"]
    log(f"phase 6: kernels vs plain versions: the argmax slot agrees at "
        f"{exact:.6f} (>= {ARGMAX_EXACT}) of the {n_px} pixels (per frame " +
        " ".join(f"{a:.6f}" for a in same_t.tolist()) + f"); {n_tie} "
        f"pixels ({n_tie / n_px:.6f}) have their two largest plain masks "
        f"within {ARGMAX_TIE:g} and are left out as ties; of the other "
        f"{n_px - n_tie}, {n_miss} disagree (must be 0); largest mask "
        f"difference {mdiff:.3e} (tol {TOL['slot_attention']:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    failed = [] if ok else ["argmax agreement"]
    for k in sorted(res_k):
        diff = abs(res_k[k] - res_p[k])
        if "loss" in k:
            tol, what = LOSS_RTOL * abs(res_p[k]), "relative 1e-3"
        else:
            tol, what = SEG_METRIC_TOL, f"{SEG_METRIC_TOL:g}"
        good = diff <= tol
        log(f"phase 6: {k} kernels {res_k[k]:.6f} plain {res_p[k]:.6f} "
            f"diff {diff:.3e} (tol {what}) {'ok' if good else 'FAIL'}")
        if not good:
            failed.append(k)
    if failed:
        raise SystemExit(f"the eval path's kernels disagree with the plain "
                         f"versions: {failed}")
    del trainer, data, live, kernel_masks, plain_masks, captured
    gc.collect()
    torch.cuda.empty_cache()

    # 3. test_seg's full-video path: 12 frames in chunks of the clip length
    clip = cfg.n_sample_frames
    vid = SyntheticVideoDataset(resolution=cfg.resolution, num_samples=1,
                                n_sample_frames=2 * clip, seed=2)[0]
    img = torch.from_numpy(vid["img"])[None].to(dev)
    apply = lambda x, prev: model({"img": x}, prev_slots=prev)
    with torch.inference_mode():
        ops.reset_launch_counts()
        out = chunked_video_apply(apply, img, clip, keys=("slots", "masks"))
        torch.cuda.synchronize()
        per_path["test_seg"] = ops.launch_counts()
        carried = apply(img[:, clip:], out["slots"][:, clip - 1])["slots"]
        fresh = apply(img[:, clip:], None)["slots"]
    seg = seg_metrics_fn({"masks": torch.from_numpy(vid["masks"])[None]},
                         out)
    S = cfg.slot_dict["num_slots"]
    shapes_ok = out["slots"].shape[:3] == (1, 2 * clip, S) and \
        out["masks"].shape == (1, 2 * clip, S, *cfg.resolution)
    carry_ok = torch.allclose(out["slots"][:, clip:], carried, rtol=1e-5,
                              atol=1e-5) and \
        (out["slots"][:, clip:] - fresh).abs().max().item() > 1e-3
    log(f"phase 6: test_seg full video of {2 * clip} frames in chunks of "
        f"{clip}: slots {tuple(out['slots'].shape)}, masks "
        f"{tuple(out['masks'].shape)}, the second chunk continues the "
        f"first's slots {'ok' if carry_ok else 'FAIL'}; " + ", ".join(
            f"{k} {v:.4f}" for k, v in seg.items()) +
        f"; launches {per_path['test_seg']}")
    if not (shapes_ok and carry_ok and
            all(map(math.isfinite, seg.values()))):
        raise SystemExit("the chunked full-video path failed")

    # 4. test_recon's batch: encode, 20 DPM-Solver++ steps, VQ decode
    vbatch = SyntheticVideoDataset(resolution=cfg.resolution,
                                   num_samples=B, n_sample_frames=T,
                                   seed=1)
    img = torch.stack([torch.from_numpy(vbatch[i]["img"])
                       for i in range(B)]).to(dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        samples = model.log_images(
            {"img": img}, torch.Generator(device=dev).manual_seed(0),
            same_noise=True)["samples"]
        torch.cuda.synchronize()
        rec_s = time.time() - t0
        per_path["test_recon"] = ops.launch_counts()
    x = (samples * 0.5 + 0.5).clamp(0, 1).flatten(0, 1)
    y = (img * 0.5 + 0.5).clamp(0, 1).flatten(0, 1)
    rec = {"mse": M.mse_metric(x, y), "psnr": M.psnr_metric(x, y),
           "ssim": M.ssim_metric(x, y)}
    log(f"phase 6: test_recon batch of {B} clips x {T} frames (20 "
        f"DPM-Solver++ steps, VQ decode): {rec_s:.3f} s wall on {smi}; " +
        ", ".join(f"{k} {v:.4f}" for k, v in rec.items()) +
        f"; launches {per_path['test_recon']}")
    if samples.shape != img.shape or \
            not all(map(math.isfinite, rec.values())):
        raise SystemExit(f"test_recon: samples {tuple(samples.shape)}, "
                         f"metrics {rec}")
    del samples, x, y, img

    # 5. slot attention at the res64 model's shape
    sa64 = SlotAttention(in_features=64, num_iterations=2, slot_size=64,
                         mlp_hidden_size=128, return_last_attn=True).to(dev)
    init_random_(sa64, torch.Generator().manual_seed(3))
    res64 = check_kernels(
        {"gn_silu": {}, "attention": {},
         "slot_attention": {(EVAL_BATCH, 4096, 6, 64, 128, 2): 1}},
        sa64, gen, dev, "phase 6 (res64 shape)")
    gc.collect()
    torch.cuda.empty_cache()
    return per_path, res64


def kernel_cases_bf16(shapes, gen, dev):
    """The bf16 entry points of GN and attention at each call shape in
    `shapes` (from `record_shapes` on the bf16 model), on random bf16
    inputs: the same tuples as `kernel_cases`. The library calls are
    `F.group_norm` (+ `F.silu`) with the affine in bf16 and SDPA, both in
    bf16; bytes at 2 a value."""
    import torch
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch.ops import attention_kernel, fused_norm
    bf16 = torch.bfloat16
    for (shape, act, eps, G), calls in sorted(shapes["gn_silu"].items(),
                                              key=lambda kv: str(kv[0])):
        C = shape[1]
        xg = (torch.randn(shape, generator=gen, device=dev) * 2 +
              0.5).to(bf16)
        wg = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bg = 0.1 * torch.randn(C, generator=gen, device=dev)
        wl, bl = wg.to(bf16), bg.to(bf16)
        n = xg.numel()
        yield ("gn_silu_bf16", calls,
               f"{tuple(shape)} act={act} eps={eps:g}",
               lambda: fused_norm.fused_group_norm(xg, wg, bg, G, eps, act),
               lambda: fused_norm.group_norm_reference(xg, wg, bg, G, eps,
                                                       act),
               (lambda: F.silu(F.group_norm(xg, G, wl, bl, eps)))
               if act == "silu" else
               (lambda: F.group_norm(xg, G, wl, bl, eps)),
               bound_terms(2 * n * 2 + 2 * C * 4,
                           f32_ops=(10 if act else 6) * n))
    for (Bq, nq, nk, heads), calls in sorted(shapes["attention"].items()):
        hd = heads * attention_kernel.HEAD_DIM
        q, k, v = (torch.randn(Bq, n, hd, generator=gen, device=dev).to(bf16)
                   for n in (nq, nk, nk))
        split = lambda t: t.view(Bq, t.shape[1], heads, -1).transpose(1, 2)
        yield ("attention_bf16", calls, f"B={Bq} Nq={nq} Nk={nk} H={heads}",
               lambda: attention_kernel.fused_mha(q, k, v, heads),
               lambda: attention_kernel.mha_reference(q, k, v, heads),
               lambda: F.scaled_dot_product_attention(split(q), split(k),
                                                      split(v)),
               # q k^T and w v on the bf16 tensor cores
               bound_terms(2 * (2 * q.numel() + 2 * k.numel()),
                           bf16_ops=4.0 * Bq * nq * nk * hd))


def check_bf16_kernels(shapes, gen, dev, phase):
    """Each bf16 entry point against its plain twin at every shape in
    `shapes`, timed, and called twice on the same inputs (the same bits).
    -> {kernel: totals over those calls}. Raises SystemExit if any
    disagrees."""
    results, failed = {}, []
    for name, calls, label, kern, plain, lib, terms in kernel_cases_bf16(
            shapes, gen, dev):
        out, ref = kern(), plain()
        same = same_bits(out, kern())
        log(f"{phase}: {name} {label}: two calls on the same inputs "
            f"{'are bit-identical' if same else 'DIFFER'}")
        if not same or out.dtype != ref.dtype:
            failed.append(f"{name} {label} not deterministic or not bf16")
        tol = BF16_TOL[name] * ref.float().abs().max().item()
        record(results, failed, phase, name, calls, label,
               max_err(out, ref), tol, timed(kern), timed(plain),
               timed(lib), terms)
    if failed:
        raise SystemExit(f"bf16 kernels disagree with their plain twins: "
                         f"{failed}")
    return results


def bf16_vs_plain(model, inputs, slots):
    """The bf16 `model`'s denoise of 2 frames and encode of one 2-frame
    clip through the kernels against the same through their plain twins
    (slot attention's with bf16 k/v), on the card, within
    BF16_PATH_TOL of each output's largest magnitude. Raises SystemExit
    otherwise."""
    import torch
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    video, x_t, t_model = inputs
    encode, denoise = (build_serving_fn(model, s)
                       for s in ("encode", "denoise"))
    with torch.inference_mode():
        runs = {}
        for how in ("kernels", "plain"):
            ctx = plain_versions(f32_slot_attention=False) \
                if how == "plain" else contextlib.nullcontext()
            with ctx:
                runs[how] = (denoise(x_t[:2], t_model[:2], slots[:1, :2]),
                             *encode(video[:1, :2]))
    for name, a, b in zip(("denoise", "encode slots", "encode masks"),
                          runs["kernels"], runs["plain"]):
        a, b = a.float(), b.float()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"phase 7: bf16 {name}, kernels vs plain versions on the card: "
            f"max rel err {rel:.2e} (tol {BF16_PATH_TOL:.0e})")
        if not rel <= BF16_PATH_TOL:
            raise SystemExit(f"bf16 {name}: kernels disagree with the "
                             "plain versions")


def main():
    import gc

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.ops import (_cuda, attention_kernel,
                                             fused_norm,
                                             slot_attention_kernel,
                                             winograd_conv)
    from slotdiffusion_tpu_torch.serving import build_serving_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    import scipy
    log(f"phase 1: device {kind} x{count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, scipy {scipy.__version__} (the "
        f"metrics' Hungarian matching and SSIM filter), tf32 off")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # ---- 2. build ---------------------------------------------------------
    t = time.time()
    lib_path = _cuda.build(verbose=True)
    _cuda.lib()
    log(f"phase 2: nvcc built {os.path.relpath(lib_path)} in "
        f"{time.time() - t:.1f}s")

    # ---- the flagship model, and the kernel shapes its serving path uses --
    cfg = configs.SAViLDMMoviE128()
    model = build_model(cfg, device="cuda")
    init_random_(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"built SAViDiffusion (MOVi-E 128x128), {n_params / 1e6:.1f}M "
        "parameters, random weights (seed 0)")
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = serving_inputs(cfg, dev)
    video, x_t, t_model = inputs
    shapes = serving_shapes(model, inputs)
    log("shapes per request: " + ", ".join(
        f"{len(calls)} {name}" for name, calls in shapes.items()))

    # ---- 3. kernels vs plain versions ------------------------------------
    sa_mod = model.savi.slot_attention
    results = check_kernels(shapes, sa_mod, gen, dev, "phase 3")
    failed = []
    # Winograd: no model calls it; the flagship UNet's ResBlock conv shapes
    # (scripts/bench_winograd.py), bf16 as the JAX kernel takes them
    wino_shapes = [(32, 32, 32, 128, 128), (32, 16, 16, 256, 256),
                   (32, 8, 8, 384, 384), (32, 4, 4, 512, 512)]
    wino_inputs, wino_extra = [], dict(transform=0.0, call=0.0,
                                       transform_plain=0.0, call_plain=0.0)
    for (Bw, Hw, Ww, C, Fo) in wino_shapes:
        xw = torch.randn(Bw, Hw, Ww, C, generator=gen, device=dev).to(
            torch.bfloat16)
        ww = torch.randn(3, 3, C, Fo, generator=gen, device=dev) * \
            (9 * C) ** -0.5
        wino_inputs.append((xw, ww))
        label = f"B={Bw} {Hw}x{Ww} C={C} F={Fo}"
        # the weight transform: U^T must equal the plain version's bit for
        # bit (the same f32 operations, then bf16)
        ut = winograd_conv.kernel_weights(ww)
        ut_plain = winograd_conv.kernel_weights_reference(ww)
        same_u = torch.equal(ut, ut_plain)
        if not same_u:
            failed.append(f"winograd_conv3x3 {Hw}x{Ww} U")
        (t_ms, t_ev), (tp_ms, _) = (
            timed(lambda: winograd_conv.kernel_weights(ww)),
            timed(lambda: winograd_conv.kernel_weights_reference(ww)))
        t_bound = max(bound_terms(9 * C * Fo * 4 + ut.numel() * 2))
        log(f"phase 3: winograd transform {label}: U equals the plain "
            f"version's {'ok' if same_u else 'FAIL'} | device (event) ms: "
            f"kernel {t_ms:.4f} ({t_ev:.4f}), plain {tp_ms:.4f}, bound "
            f"{t_bound:.4f} (bytes)")
        # the convolution on U, against F.conv2d with its weights already
        # in bf16 (channels-last): like for like
        kern = lambda: winograd_conv.winograd_conv3x3_u(xw, ut, Fo)
        plain = lambda: winograd_conv.winograd_reference_u(xw, ut, Fo)
        xc = xw.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        wc = ww.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = lambda: F.conv2d(xc, wc, padding=1)
        y, ref = kern().float(), plain().float()
        err = (y - ref).abs().max().item()
        f32 = winograd_conv.direct_conv(xw.float(), ww)
        rel32 = ((y - f32).abs().max() / f32.abs().max()).item()
        log(f"phase 3: winograd_conv3x3 {label}: vs the f32 direct conv "
            f"{rel32:.2e} of its scale (tol {WINO_F32_TOL:.0e})")
        if not rel32 <= WINO_F32_TOL:
            failed.append(f"winograd_conv3x3 {Hw}x{Ww} vs f32 conv")
        terms = bound_terms(
            2 * (Bw * Hw * Ww * C + 16 * C * Fo + Bw * Hw * Ww * Fo),
            bf16_ops=8.0 * Bw * Hw * Ww * C * Fo)
        record(results, failed, "phase 3", "winograd_conv3x3", 1,
               f"conv on U {label}", err, WINO_TOL * ref.abs().max().item(),
               timed(kern), timed(plain), timed(lib), terms)
        # the whole call (transform + convolution), as a caller without U
        call = lambda: winograd_conv.winograd_conv3x3(xw, ww)
        call_plain = lambda: winograd_conv.winograd_reference(xw, ww)
        c_err = (call().float() - call_plain().float()).abs().max().item()
        (c_ms, c_ev), (cp_ms, _) = timed(call), timed(call_plain)
        c_tol = WINO_TOL * ref.abs().max().item()
        if not c_err <= c_tol:
            failed.append(f"winograd_conv3x3 {Hw}x{Ww} whole call")
        log(f"phase 3: winograd whole call {label}: max_abs_err "
            f"{c_err:.3e} (tol {c_tol:.1e}) "
            f"{'ok' if c_err <= c_tol else 'FAIL'} | device (event) ms: "
            f"kernel {c_ms:.4f} ({c_ev:.4f}), plain {cp_ms:.4f}")
        for key, val in (("transform", t_ms), ("call", c_ms),
                         ("transform_plain", tp_ms), ("call_plain", cp_ms)):
            wino_extra[key] += val
    # ragged edges the serving shapes do not reach: a partial query tile
    # and key tile, a partial k/v tile, more keys than one pass stages,
    # few slots, other widths; (name, shape label, error, tolerance)
    edge = []
    for (Bq, nq, nk, heads) in ((3, 100, 70, 3), (2, 40, 300, 2)):
        q = torch.randn(Bq, nq, 32 * heads, generator=gen, device=dev)
        k = torch.randn(Bq, nk, 32 * heads, generator=gen, device=dev)
        err = (attention_kernel.fused_mha(q, k, k, heads) -
               attention_kernel.mha_reference(q, k, k, heads)
               ).abs().max().item()
        edge.append(("attention", f"Nq={nq} Nk={nk}", err, TOL["attention"]))
    D, M = 64, 128
    pe = {key: torch.randn(shp, generator=gen, device=dev) * 0.1
          for key, shp in sa_weight_shapes(D, M).items()}
    ks = torch.randn(3, 1000, D, generator=gen, device=dev)
    s0 = torch.randn(3, 7, D, generator=gen, device=dev)
    kw = dict(num_iterations=3, eps=1e-6, return_last_attn=True)
    (ko, km) = slot_attention_kernel.sa_iterations(ks, ks, s0, pe, **kw)
    (po, pm) = slot_attention_kernel.sa_iterations_ref(ks, ks, s0, pe, **kw)
    edge.append(("slot_attention", "N=1000 S=7 D=64",
                 max((ko - po).abs().max().item(),
                     (km - pm).abs().max().item()), TOL["slot_attention"]))
    # one item on a cluster of 16 with all 16 slots; N = 1001 (not a
    # multiple of 16 blocks); D = 66 (not a multiple of 8 or 16: 4-byte
    # k/v copies, zero-padded MMA depth); the largest S, D and M
    for (Bs, N, S, D, M) in ((1, 1024, 16, 192, 384), (2, 1001, 15, 192, 384),
                             (2, 77, 5, 66, 100), (3, 300, 16, 256, 1024)):
        pe = {key: torch.randn(shp, generator=gen, device=dev) * (
            shp[0] ** -0.5 if len(shp) == 2 else 0.1)
            for key, shp in sa_weight_shapes(D, M).items()}
        ks, vs = (torch.randn(Bs, N, D, generator=gen, device=dev)
                  for _ in range(2))
        s0 = torch.randn(Bs, S, D, generator=gen, device=dev)
        kw = dict(num_iterations=2, eps=1e-8, return_last_attn=True)
        out = slot_attention_kernel.sa_iterations(ks, vs, s0, pe, **kw)
        ref = slot_attention_kernel.sa_iterations_ref(ks, vs, s0, pe, **kw)
        label = (f"B={Bs} N={N} S={S} D={D} M={M} plan "
                 f"{slot_attention_kernel.launch_plan(Bs, N, S, D, M)}")
        if not same_bits(out, slot_attention_kernel.sa_iterations(
                ks, vs, s0, pe, **kw)):
            failed.append(f"slot_attention edge {label} not deterministic")
        edge.append(("slot_attention", label, max_err(out, ref),
                     TOL["slot_attention"]))
    xg = torch.randn(5, 96, 7, 9, generator=gen, device=dev)
    wg = torch.ones(96, device=dev)
    edge.append(("gn_silu", "(5, 96, 7, 9)", (
        fused_norm.fused_group_norm(xg, wg, wg, 24, 1e-5, "silu") -
        fused_norm.group_norm_reference(xg, wg, wg, 24, 1e-5, "silu")
    ).abs().max().item(), TOL["gn_silu"]))
    # runs of 50 values (not a multiple of 4): the 4-byte path
    xg = torch.randn(2, 6, 5, 5, generator=gen, device=dev)
    wg = 1 + 0.1 * torch.randn(6, generator=gen, device=dev)
    edge.append(("gn_silu", "(2, 6, 5, 5) G=3", (
        fused_norm.fused_group_norm(xg, wg, wg, 3, 1e-5, None) -
        fused_norm.group_norm_reference(xg, wg, wg, 3, 1e-5, None)
    ).abs().max().item(), TOL["gn_silu"]))
    # Winograd: partial tile and channel blocks, odd H or W, C not a
    # multiple of the kernel's 64-channel chunk; C = 70 takes the V pass's
    # two-channel path (C not a multiple of 4)
    for (Bw, Hw, Ww, C, Fo) in ((3, 9, 14, 72, 40), (2, 7, 5, 70, 24)):
        xw = torch.randn(Bw, Hw, Ww, C, generator=gen, device=dev).to(
            torch.bfloat16)
        ww = torch.randn(3, 3, C, Fo, generator=gen, device=dev) * 0.04
        ref = winograd_conv.winograd_reference(xw, ww).float()
        edge.append(("winograd_conv3x3", f"({Bw}, {Hw}, {Ww}, {C}) F={Fo}",
                     (winograd_conv.winograd_conv3x3(xw, ww).float() - ref
                      ).abs().max().item(),
                     WINO_TOL * ref.abs().max().item()))
    host = gn_host_split(dev)
    log("phase 3: GN wrapper host us a call (12x512x4x4): " + ", ".join(
        f"{k} {v:.2f}" for k, v in host.items()))
    for name, label, err, tol in edge:
        ok = err <= tol
        log(f"phase 3: {name} ragged-edge shape {label}: max_abs_err "
            f"{err:.3e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} edge {label}")
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")

    # the Winograd kernel's own path: its public entry point at the four
    # shapes, with the counts set to 0 just before and read just after
    ops.reset_launch_counts()
    for xw, ww in wino_inputs:
        winograd_conv.winograd_conv3x3(xw, ww)
    torch.cuda.synchronize()
    per_path = {"winograd_conv3x3": ops.launch_counts()}
    log(f"phase 3: launches through winograd_conv3x3 "
        f"{per_path['winograd_conv3x3']}")

    # ---- 3b. the autograd.Functions' gradients on the card -------------
    cases = model_grad_cases(shapes, sa_mod, gen, dev)
    cases["winograd_conv3x3"] = (winograd_conv.winograd_conv3x3,
                                 winograd_conv.direct_conv, wino_inputs[1])
    check_grads(cases, gen, dev, "phase 3b")

    # ---- 4. the serving path through the kernels -------------------------
    per_surface, surface_seconds, slots = serve(cfg, model, inputs,
                                                "phase 4")
    per_path["serving"] = {k: sum(c[k] for c in per_surface.values())
                           for k in ops.launch_counts()}
    log(f"phase 4: launches on the serving path {per_path['serving']}")

    # the same model on the CPU runs the plain versions: one denoise frame
    # and one 2-frame encode must agree with the card's kernel path
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    d_gpu = build_serving_fn(model, "denoise")(
        x_t[:1], t_model[:1], slots[:1, :1]).cpu()
    d_cpu = build_serving_fn(cpu, "denoise")(
        x_t[:1].cpu(), t_model[:1].cpu(), slots[:1, :1].cpu())
    s_gpu, m_gpu = build_serving_fn(model, "encode")(video[:1, :2])
    s_cpu, m_cpu = build_serving_fn(cpu, "encode")(video[:1, :2].cpu())
    # f32 through ~100 layers whose sums run in another order on the card:
    # 1e-3 of the output's scale. The encode also rounds k, v, q and the
    # attention weights to bf16 after f32 sums that differ in their last
    # bits, so a few elements land one bf16 ulp (2^-8 relative) apart and
    # a large q_d * k_d term moves a logit by up to ~1e-2 and a mask value
    # by a quarter of that: 1e-2 there
    for name, a, b, tol in (("denoise", d_gpu, d_cpu, 1e-3),
                            ("encode slots", s_gpu.cpu(), s_cpu, 1e-2),
                            ("encode masks", m_gpu.cpu(), m_cpu, 1e-2)):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"phase 4: {name} card vs CPU plain path: max rel err "
            f"{rel:.2e} (tol {tol:.0e})")
        if not rel <= tol:
            raise SystemExit(f"{name}: the card disagrees with the CPU")
    del cpu

    # ---- 5. the training path --------------------------------------------
    per_path["training"], train_results, step_seconds = train(
        cfg, model, dev, gen, "phase 5")

    # ---- 6. the evaluation path ------------------------------------------
    eval_paths, res64 = evaluate(cfg, model, dev, gen, smi, "phase 6")
    per_path.update(eval_paths)
    del model, sa_mod, cases
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7. the flagship in bf16: phases 4-6 again ------------------------
    cfg16 = cfg.copy(use_bf16=True)
    model = build_model(cfg16, device="cuda")
    init_random_(model, torch.Generator().manual_seed(0))
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise SystemExit("the bf16 model's parameters are not all f32")
    log("phase 7: built SAViDiffusion (MOVi-E 128x128) with use_bf16: "
        "bf16 compute, f32 parameters, random weights (seed 0, as phase 4)")
    bf16_serve = check_bf16_kernels(serving_shapes(model, inputs), gen,
                                    dev, "phase 7")
    per_surface16, _, slots = serve(cfg16, model, inputs, "phase 7",
                                    surface_seconds)
    per_path["bf16_serving"] = {k: sum(c[k] for c in per_surface16.values())
                                for k in ops.launch_counts()}
    bf16_vs_plain(model, inputs, slots)
    per_path["bf16_training"], bf16_train, _ = train(
        cfg16, model, dev, gen, "phase 7", step_seconds)
    per_path.update(evaluate(cfg16, model, dev, gen, smi, "phase 7")[0])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for name, r in bf16_serve.items():
        base = results[name.removesuffix("_bf16")]
        log(f"phase 7: {name} per serving request {r['ms']:.4f} ms device "
            f"(f32 entry, phase 3: {base['ms']:.4f} ms), bound "
            f"{max(r['t_bytes'], r['t_ops']):.4f} ms (f32: "
            f"{max(base['t_bytes'], base['t_ops']):.4f}), library "
            f"{r['lib']:.4f} ms (f32: {base['lib']:.4f}); per training "
            f"step's forward {bf16_train[name]['ms']:.4f} ms (f32, phase 5:"
            f" {train_results[name.removesuffix('_bf16')]['ms']:.4f} ms)")

    # ---- 8. report ------------------------------------------------------
    mods = {m.KERNEL_NAME: m for m in ops.KERNEL_MODULES}
    kernels = []
    for name, r in results.items():
        m = mods[name]
        extra = {} if name != "winograd_conv3x3" else {
            # `ms` is the convolution on U; these the transform and the
            # whole call, summed over the same four shapes
            "transform_ms": wino_extra["transform"],
            "transform_plain_ms": wino_extra["transform_plain"],
            "call_ms": wino_extra["call"],
            "call_plain_ms": wino_extra["call_plain"]}
        kernels.append({
            "name": name, "route": m.ROUTE, "source": m.SOURCE,
            "replaces": f"{ops.REFERENCE_PACKAGE}/{m.REPLACES}",
            "launches": sum(c[name] for c in per_path.values()),
            "max_abs_err": max(r["err"], train_results.get(
                name, {"err": 0.0})["err"]),
            "ms": r["ms"], "event_ms": r["event"],
            "plain_ms": r["plain"],
            "bound_ms": max(r["t_bytes"], r["t_ops"]),
            "bound_by": ("bytes" if r["t_bytes"] >= r["t_ops"]
                         else "operations"),
            "library_ms": r["lib"] if r["has_lib"] else None,
            "train_ms": train_results[name]["ms"]
            if name in train_results else None,
            "train_plain_ms": train_results[name]["plain"]
            if name in train_results else None,
            "per_path_launches": {s: c[name] for s, c in per_path.items()},
            "per_surface_launches": {s: c[name]
                                     for s, c in per_surface.items()},
            **({} if name not in res64 else {
                # one call at the res64 model's shape (phase 6)
                "res64_ms": res64[name]["ms"],
                "res64_plain_ms": res64[name]["plain"],
                "res64_bound_ms": max(res64[name]["t_bytes"],
                                      res64[name]["t_ops"]),
                "res64_max_abs_err": res64[name]["err"]}),
            **extra,
        })
    for name, r in bf16_serve.items():
        base = name.removesuffix("_bf16")
        m, tr = mods[base], bf16_train[name]
        kernels.append({
            "name": name, "entry": m.ENTRY[torch.bfloat16], "dtype": "bf16",
            "route": m.ROUTE, "source": m.SOURCE,
            "replaces": f"{ops.REFERENCE_PACKAGE}/{m.REPLACES}",
            "launches": sum(c[name] for c in per_path.values()),
            "max_abs_err": max(r["err"], tr["err"]),
            "ms": r["ms"], "event_ms": r["event"], "plain_ms": r["plain"],
            "bound_ms": max(r["t_bytes"], r["t_ops"]),
            "bound_by": ("bytes" if r["t_bytes"] >= r["t_ops"]
                         else "operations"),
            "library_ms": r["lib"],
            "train_ms": tr["ms"], "train_plain_ms": tr["plain"],
            "train_library_ms": tr["lib"],
            "train_bound_ms": max(tr["t_bytes"], tr["t_ops"]),
            # the f32 entry point at the same shapes (phases 3 and 5)
            "f32_ms": results[base]["ms"],
            "f32_train_ms": train_results[base]["ms"],
            "per_path_launches": {s: c[name] for s, c in per_path.items()},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
