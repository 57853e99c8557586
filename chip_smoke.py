#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`slotdiffusion_tpu_torch`) on one CUDA
card: build the kernels, hold each against its plain version, serve and
train the flagship SAViDiffusion at full width, and report.

    python3 chip_smoke.py

Phases (one flushed line each, with elapsed seconds):
  1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
  2. build: nvcc compiles csrc/*.cu into one library, Triton compiles the
     GN kernel;
  3. every kernel against its plain PyTorch version on the card at the
     shapes the serving path gives it (collected from one denoise call and
     one encode), with its error beside the stated tolerance, its device
     time per call (CUDA events around a CUDA graph of back-to-back calls)
     and its CUDA-event time over eager calls, the plain
     version's, one PyTorch call's where one computes the same function,
     and the least time the card could take (`bound_ms`); the Winograd
     kernel, which no model calls, at the flagship UNet's four ResBlock
     conv shapes (scripts/bench_winograd.py) and through its own entry
     point with the launch counts set to 0 before and read after;
  3b. each kernel's autograd.Function on the card, at the largest of its
     serving shapes (Winograd: the second bench shape): the gradients of
     a random projection of its output through the kernel path against
     the plain path's (the function its backward differentiates), and
     non-zero;
  4. the flagship SAViDiffusion (MOVi-E 128x128, random weights from a
     seeded generator) answers `encode` on 2 videos x 6 frames, `sample`
     (DPM-Solver++, 20 steps, then VQ decode) and one `denoise`, with the
     kernels' launch counts set to 0 before and read after; its outputs
     are checked for shape and finiteness, the masks for summing to one
     over the slots, and one denoise and one encode against the same
     model run on the CPU (the plain versions);
  5. training the same model: the three model kernels against their
     plain versions, timed, at every shape one training step gives them
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
  6. one JSON line listing every kernel (times per serving request;
     `train_ms` / `train_plain_ms`: per training step's forward calls),
     then the card's name and power limit, then the result line.

It exits non-zero, printing no result line, when there is no CUDA card,
when the port is not beside it, or when any phase fails. Matmuls and
convolutions run in full f32 (TF32 off) so that the comparisons hold the
kernels' f32 arithmetic.
"""

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
TRAIN_BATCHES = (32, 16, 8, 4)  # clips a step: the config's, then cuts
TRAIN_STEPS = 3


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


def bound_terms(nbytes, f32_ops=0.0, bf16_ops=0.0):
    """(ms to move the bytes, ms to do the operations) at the peaks: each
    input read once, each output written once."""
    return (1e3 * nbytes / HBM_BYTES_PER_S,
            1e3 * (f32_ops / F32_FLOPS + bf16_ops / BF16_FLOPS))


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
               bound_terms(4 * (2 * q.numel() + 2 * k.numel()),
                           f32_ops=4.0 * Bq * nq * nk * hd))
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
        yield ("slot_attention", calls,
               f"B={Bs} N={N} S={S} D={D} iters={iters}",
               lambda: slot_attention_kernel.sa_iterations(ks, vs, s0, p,
                                                           **kw),
               lambda: slot_attention_kernel.sa_iterations_ref(ks, vs, s0,
                                                               p, **kw),
               None,
               bound_terms(nbytes, bf16_ops=mm * 2 * N * D,
                           f32_ops=mm * D * (D + 6 * D + 2 * M)))


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
    lib = "n/a" if l_ms is None else f"{l_ms:.4f} ({l_ev:.4f}) ms"
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


def check_kernels(shapes, sa_mod, gen, dev, phase):
    """Every model kernel against its plain version at every shape in
    `shapes`, timed; -> {kernel: totals over those calls}. Raises
    SystemExit if any disagrees."""
    results, failed = {}, []
    for name, calls, label, kern, plain, lib, terms in kernel_cases(
            shapes, sa_mod, gen, dev):
        record(results, failed, phase, name, calls, label,
               max_err(kern(), plain()), TOL[name], timed(kern),
               timed(plain), None if lib is None else timed(lib), terms)
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")
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


def train(cfg, model, dev, gen):
    """Phase 5: hold the kernels against their plain versions at the
    shapes of a training step, then train the built flagship `model`
    through the port's entry points; -> ({kernel: launches} over the
    Trainer's steps, {kernel: totals over one step's forward calls})."""
    import gc
    import tempfile

    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import blocks, slot_attention, unet
    from slotdiffusion_tpu_torch.ops import (attention_kernel, fused_norm,
                                             slot_attention_kernel)

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
        log(f"phase 5: {bs} clips a step: peak "
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
    log(f"phase 5: training at {batch} clips x {T} frames a step{cut}")

    # the kernels and their gradients at this training step's shapes
    sa_mod = model.savi.slot_attention
    train_results = check_kernels(shapes, sa_mod, gen, dev, "phase 5")
    check_grads(model_grad_cases(shapes, sa_mod, gen, dev), gen, dev,
                "phase 5")
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

    class StepReport:
        """The trainer's logger: per step, the kernels' launches since the
        last reset (then reset), the peak memory and the metrics."""

        def __init__(self):
            self.steps = []

        def log(self, record, step):
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            ops.reset_launch_counts()
            peak = torch.cuda.max_memory_allocated() / gib
            self.steps.append(dict(record, launches=counts))
            log(f"phase 5: step {step}: denoise_loss "
                f"{record['train/denoise_loss']:.5f}, grad norm "
                f"{record.get('train/grad_norm', float('nan')):.4g}, lr "
                f"{record.get('lr', float('nan')):.3g}, "
                f"{record['step_seconds']:.3f} s (host clock), max "
                f"allocated {peak:.2f} GiB, launches {counts}")

    totals = dict.fromkeys(ops.launch_counts(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = build_method(model, data, tcfg,
                               ckp_path=os.path.join(tmp, "run"))
        trainer.logger = report = StepReport()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.time()
        trainer.fit(max_steps=TRAIN_STEPS)
        log(f"phase 5: Trainer.fit(max_steps={TRAIN_STEPS}) took "
            f"{time.time() - t0:.1f}s (host clock, ckpt_last included)")
        for hk in hooks:
            hk.remove()
        for st in report.steps:
            for k, n in st["launches"].items():
                totals[k] += n
        losses = [st["train/denoise_loss"] for st in report.steps]
        if len(losses) != TRAIN_STEPS or not all(
                map(math.isfinite, losses)):
            raise SystemExit(f"training losses {losses}")
        idle = [k for st in report.steps for k in MODEL_KERNELS
                if st["launches"][k] == 0]
        if idle:
            raise SystemExit(f"a training step launched none of {idle}")
        no_grad = [n for n, _ in trainable
                   if n not in got_grad or not bool(got_grad[n])]
        if no_grad:
            raise SystemExit(f"{len(no_grad)} trainable parameters got no "
                             f"gradient, e.g. {no_grad[:5]}")
        still = [n for n, p in trainable if torch.equal(p, start[n])]
        if still:
            raise SystemExit(f"{len(still)} parameters did not move, e.g. "
                             f"{still[:5]}")
        log(f"phase 5: {len(trainable)} trainable tensors outside the "
            f"VQ-VAE all got non-zero gradients and moved")
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
        log(f"phase 5: resumed from ckpt_last ({size:.2f} GiB) at step "
            f"{TRAIN_STEPS}, took step {resumed.step}")
        del resumed
    gc.collect()
    torch.cuda.empty_cache()

    # one 2-clip step's gradients through the kernels and through the plain
    # versions (the JAX model's own off-TPU computation: slot attention in
    # f32), the same generator state, dropout off (eval mode)
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
    plain = {
        (blocks, "fused_group_norm"): fused_norm.group_norm_reference,
        (unet, "fused_mha"): attention_kernel.mha_reference,
        (slot_attention, "sa_iterations"):
            lambda *a, kv_dtype=None, **kw:
            slot_attention_kernel.sa_iterations_ref(
                *a, kv_dtype=torch.float32, **kw)}
    saved = {key: getattr(*key) for key in plain}
    try:
        for (mod, attr), fn in plain.items():
            setattr(mod, attr, fn)
        ops.reset_launch_counts()
        loss_p, grads_p = step_grads()
        if any(ops.launch_counts().values()):
            raise SystemExit("the plain path launched a kernel")
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    model.zero_grad(set_to_none=True)
    floor = 1e-2 * max(g.abs().max().item() for g in grads_p.values())
    worst = max((((grads_k[n] - g).abs().max() /
                  max(g.abs().max().item(), floor)).item(), n)
                for n, g in grads_p.items())
    log(f"phase 5: 2-clip step, kernels vs plain versions: loss "
        f"{loss_k:.6f} vs {loss_p:.6f}; largest gradient error {worst[0]:.2e}"
        f" of its parameter's scale at {worst[1]} (tol {TRAIN_GRAD_TOL:.0e})")
    if not worst[0] <= TRAIN_GRAD_TOL:
        raise SystemExit("training gradients through the kernels disagree "
                         "with the plain versions'")
    return totals, train_results


def main():
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
    log(f"phase 1: device {kind} x{count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, tf32 off")
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
    t = time.time()
    x = torch.randn(1, 32, 4, 4, device=dev)
    fused_norm.fused_group_norm(x, torch.ones(32, device=dev),
                                torch.zeros(32, device=dev), 32)
    torch.cuda.synchronize()
    log(f"phase 2: triton compiled the GN kernel in {time.time() - t:.1f}s")

    # ---- the flagship model, and the kernel shapes its serving path uses --
    cfg = configs.SAViLDMMoviE128()
    model = build_model(cfg, device="cuda")
    init_random_(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"built SAViDiffusion (MOVi-E 128x128), {n_params / 1e6:.1f}M "
        "parameters, random weights (seed 0)")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, T, (H, W) = 2, cfg.n_sample_frames, cfg.resolution
    video = torch.rand(B, T, H, W, 3, generator=gen, device=dev) * 2 - 1
    encode = build_serving_fn(model, "encode")
    sample = build_serving_fn(model, "sample")
    denoise = build_serving_fn(model, "denoise")
    h, w = cfg.dec_dict["resolution"]
    x_t = torch.randn(B * T, h, w, 3, generator=gen, device=dev)
    t_model = torch.full((B * T,), 500.0, device=dev)

    shapes, handles = record_shapes(model)
    slots, _ = encode(video)
    denoise(x_t, t_model, slots)
    torch.cuda.synchronize()
    for hk in handles:
        hk.remove()
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
    wino_inputs = []
    for (Bw, Hw, Ww, C, Fo) in wino_shapes:
        xw = torch.randn(Bw, Hw, Ww, C, generator=gen, device=dev).to(
            torch.bfloat16)
        ww = torch.randn(3, 3, C, Fo, generator=gen, device=dev) * \
            (9 * C) ** -0.5
        wino_inputs.append((xw, ww))
        kern = lambda: winograd_conv.winograd_conv3x3(xw, ww)
        plain = lambda: winograd_conv.winograd_reference(xw, ww)
        xc = xw.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        wc = ww.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = lambda: F.conv2d(xc, wc, padding=1)
        y, ref = kern().float(), plain().float()
        err = (y - ref).abs().max().item()
        f32 = winograd_conv.direct_conv(xw.float(), ww)
        rel32 = ((y - f32).abs().max() / f32.abs().max()).item()
        log(f"phase 3: winograd_conv3x3 B={Bw} {Hw}x{Ww} C={C} F={Fo}: "
            f"vs the f32 direct conv {rel32:.2e} of its scale (tol "
            f"{WINO_F32_TOL:.0e})")
        if not rel32 <= WINO_F32_TOL:
            failed.append(f"winograd_conv3x3 {Hw}x{Ww} vs f32 conv")
        terms = bound_terms(
            2 * (Bw * Hw * Ww * C + 16 * C * Fo + Bw * Hw * Ww * Fo),
            bf16_ops=8.0 * Bw * Hw * Ww * C * Fo)
        record(results, failed, "phase 3", "winograd_conv3x3", 1,
               f"B={Bw} {Hw}x{Ww} C={C} F={Fo}", err,
               WINO_TOL * ref.abs().max().item(), timed(kern), timed(plain),
               timed(lib), terms)
    # ragged edges the serving shapes do not reach: a partial query tile
    # and key tile, a partial k/v tile, few slots, other widths
    q = torch.randn(3, 100, 96, generator=gen, device=dev)
    k = torch.randn(3, 70, 96, generator=gen, device=dev)
    err = (attention_kernel.fused_mha(q, k, k, 3) -
           attention_kernel.mha_reference(q, k, k, 3)).abs().max().item()
    edge = {"attention": err}
    D, M = 64, 128
    pe = {"wq": (D, D), "ln_q_scale": (D,), "ln_q_bias": (D,),
          "gru_wi": (D, 3 * D), "gru_bi": (3 * D,), "gru_wh": (D, 3 * D),
          "gru_bh": (3 * D,), "ln_mlp_scale": (D,), "ln_mlp_bias": (D,),
          "w1": (D, M), "b1": (M,), "w2": (M, D), "b2": (D,)}
    pe = {key: torch.randn(shp, generator=gen, device=dev) * 0.1
          for key, shp in pe.items()}
    ks = torch.randn(3, 1000, D, generator=gen, device=dev)
    s0 = torch.randn(3, 7, D, generator=gen, device=dev)
    kw = dict(num_iterations=3, eps=1e-6, return_last_attn=True)
    (ko, km) = slot_attention_kernel.sa_iterations(ks, ks, s0, pe, **kw)
    (po, pm) = slot_attention_kernel.sa_iterations_ref(ks, ks, s0, pe, **kw)
    edge["slot_attention"] = max((ko - po).abs().max().item(),
                                 (km - pm).abs().max().item())
    xg = torch.randn(5, 96, 7, 9, generator=gen, device=dev)
    wg = torch.ones(96, device=dev)
    edge["gn_silu"] = (fused_norm.fused_group_norm(xg, wg, wg, 24, 1e-5,
                                                   "silu") -
                       fused_norm.group_norm_reference(
                           xg, wg, wg, 24, 1e-5, "silu")).abs().max().item()
    # Winograd: partial tile and channel blocks, odd H, C not a multiple
    # of the kernel's 16-channel chunk
    xw = torch.randn(3, 9, 14, 72, generator=gen, device=dev).to(
        torch.bfloat16)
    ww = torch.randn(3, 3, 72, 40, generator=gen, device=dev) * 0.04
    ref = winograd_conv.winograd_reference(xw, ww).float()
    edge["winograd_conv3x3"] = (
        winograd_conv.winograd_conv3x3(xw, ww).float() - ref
    ).abs().max().item()
    edge_tol = dict(TOL, winograd_conv3x3=WINO_TOL * ref.abs().max().item())
    for name, err in edge.items():
        ok = err <= edge_tol[name]
        log(f"phase 3: {name} ragged-edge shape: max_abs_err {err:.3e} "
            f"(tol {edge_tol[name]:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} edge")
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
    ops.reset_launch_counts()
    per_surface = {}
    before = ops.launch_counts()
    for name, fn in (("encode", lambda: encode(video)),
                     ("sample", lambda: sample(0, slots)),
                     ("denoise", lambda: denoise(x_t, t_model, slots))):
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        per_surface[name] = {k: after[k] - before[k] for k in after}
        before = after
        if name == "encode":
            slots, masks = out
            outs = {"slots": slots, "masks": masks}
        else:
            outs = {name: out}
        log(f"phase 4: {name} in {time.time() - t:.2f}s -> " + ", ".join(
            f"{k} {tuple(v.shape)}" for k, v in outs.items()) +
            f"; launches {per_surface[name]}")
        for k, v in outs.items():
            if not torch.isfinite(v).all():
                raise SystemExit(f"{name}: non-finite values in {k}")
        if name == "encode":
            S, D = cfg.slot_dict["num_slots"], cfg.slot_dict["slot_size"]
            assert slots.shape == (B, T, S, D), slots.shape
            assert masks.shape == (B, T, S, H, W), masks.shape
            msum = (masks.sum(2) - 1).abs().max().item()
            if msum > 1e-4:
                raise SystemExit(f"masks do not sum to 1 over the slots "
                                 f"({msum:.2e})")
        elif name == "sample":
            assert out.shape == (B, T, H, W, 3), out.shape
        else:
            assert out.shape == x_t.shape, out.shape
    per_path["serving"] = ops.launch_counts()
    log(f"phase 4: launches on the serving path {per_path['serving']}")
    missing = [k for k in MODEL_KERNELS if per_path["serving"][k] == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: "
                         f"{missing}")

    # the same model on the CPU runs the plain versions: one denoise frame
    # and one 2-frame encode must agree with the card's kernel path
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    d_gpu = denoise(x_t[:1], t_model[:1], slots[:1, :1]).cpu()
    d_cpu = build_serving_fn(cpu, "denoise")(
        x_t[:1].cpu(), t_model[:1].cpu(), slots[:1, :1].cpu())
    s_gpu, m_gpu = encode(video[:1, :2])
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
    per_path["training"], train_results = train(cfg, model, dev, gen)

    # ---- 6. report ------------------------------------------------------
    mods = {m.KERNEL_NAME: m for m in ops.KERNEL_MODULES}
    kernels = []
    for name, r in results.items():
        m = mods[name]
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
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
