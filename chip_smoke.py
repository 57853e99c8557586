#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`slotdiffusion_tpu_torch`) on one CUDA
card: build the kernels, hold each against its plain version, serve the
flagship SAViDiffusion at full width, and report.

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
     and the least time the card could take (`bound_ms`);
  4. the flagship SAViDiffusion (MOVi-E 128x128, random weights from a
     seeded generator) answers `encode` on 2 videos x 6 frames, `sample`
     (DPM-Solver++, 20 steps, then VQ decode) and one `denoise`, with the
     kernels' launch counts set to 0 before and read after; its outputs
     are checked for shape and finiteness, the masks for summing to one
     over the slots, and one denoise and one encode against the same
     model run on the CPU (the plain versions);
  5. one JSON line listing every kernel, then the card's name and power
     limit, then the result line.

It exits non-zero, printing no result line, when there is no CUDA card,
when the port is not beside it, or when any phase fails. Matmuls and
convolutions run in full f32 (TF32 off) so that the comparisons hold the
kernels' f32 arithmetic.
"""

import json
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.models.blocks import GroupNorm32
    from slotdiffusion_tpu_torch.models.unet import CrossAttention
    from slotdiffusion_tpu_torch.ops import (_cuda, attention_kernel,
                                             fused_norm,
                                             slot_attention_kernel)
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

    gn_calls, attn_calls, sa_calls = {}, {}, {}

    def gn_hook(mod, args):
        if mod.fused:
            key = (tuple(args[0].shape), mod.act, mod.eps, mod.num_groups)
            gn_calls[key] = gn_calls.get(key, 0) + 1

    def attn_hook(mod, args):
        x, ctx = args[0], (args[1] if len(args) > 1 else None)
        nk = x.shape[1] if ctx is None else ctx.shape[1]
        key = (x.shape[0], x.shape[1], nk, mod.num_heads)
        attn_calls[key] = attn_calls.get(key, 0) + 1

    def sa_hook(mod, args):
        key = (args[0].shape[0], args[0].shape[1], args[1].shape[1],
               mod.project_k.out_features, mod.mlp[1].out_features,
               mod.num_iterations)
        sa_calls[key] = sa_calls.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(fn) for m in model.modules()
             for cls, fn in ((GroupNorm32, gn_hook),
                             (CrossAttention, attn_hook),
                             (type(model.savi.slot_attention), sa_hook))
             if isinstance(m, cls)]
    slots, _ = encode(video)
    denoise(x_t, t_model, slots)
    torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    log(f"shapes per request: {len(gn_calls)} GN, {len(attn_calls)} "
        f"attention, {len(sa_calls)} slot-attention shapes")

    # ---- 3. kernels vs plain versions ------------------------------------
    results = {}
    failed = []

    def record(name, calls, err, k_t, p_t, l_t, terms, label):
        (k_ms, k_ev), (p_ms, p_ev) = k_t, p_t
        l_ms, l_ev = l_t if l_t is not None else (None, None)
        b_ms = max(terms)
        b_by = "bytes" if terms[0] >= terms[1] else "operations"
        ok = err <= TOL[name]
        if not ok:
            failed.append(f"{name} {label}")
        lib = "n/a" if l_ms is None else f"{l_ms:.4f} ({l_ev:.4f}) ms"
        log(f"phase 3: {name} {label} x{calls}: max_abs_err {err:.3e} "
            f"(tol {TOL[name]:.0e}) {'ok' if ok else 'FAIL'} | device "
            f"(event) ms: kernel {k_ms:.4f} ({k_ev:.4f}), plain "
            f"{p_ms:.4f} ({p_ev:.4f}), library {lib}, bound {b_ms:.4f} "
            f"({b_by})")
        r = results.setdefault(name, dict(err=0.0, ms=0.0, event=0.0,
                                          plain=0.0, lib=0.0, t_bytes=0.0,
                                          t_ops=0.0,
                                          has_lib=l_ms is not None))
        r["err"] = max(r["err"], err)
        r["ms"] += calls * k_ms
        r["event"] += calls * k_ev
        r["plain"] += calls * p_ms
        r["lib"] += calls * (l_ms or 0.0)
        r["t_bytes"] += calls * terms[0]
        r["t_ops"] += calls * terms[1]

    for (shape, act, eps, G), calls in sorted(gn_calls.items(),
                                              key=lambda kv: str(kv[0])):
        C = shape[1]
        xg = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
        wg = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bg = 0.1 * torch.randn(C, generator=gen, device=dev)
        kern = lambda: fused_norm.fused_group_norm(xg, wg, bg, G, eps, act)
        plain = lambda: fused_norm.group_norm_reference(xg, wg, bg, G, eps,
                                                        act)
        lib = (lambda: F.silu(F.group_norm(xg, G, wg, bg, eps))) \
            if act == "silu" else (lambda: F.group_norm(xg, G, wg, bg, eps))
        err = (kern() - plain()).abs().max().item()
        n = xg.numel()
        terms = bound_terms(2 * n * 4 + 2 * C * 4,
                            f32_ops=(10 if act else 6) * n)
        record("gn_silu", calls, err, timed(kern), timed(plain), timed(lib),
               terms, f"{tuple(shape)} act={act} eps={eps:g}")

    for (Bq, nq, nk, heads), calls in sorted(attn_calls.items()):
        hd = heads * attention_kernel.HEAD_DIM
        q = torch.randn(Bq, nq, hd, generator=gen, device=dev)
        k = torch.randn(Bq, nk, hd, generator=gen, device=dev)
        v = torch.randn(Bq, nk, hd, generator=gen, device=dev)
        kern = lambda: attention_kernel.fused_mha(q, k, v, heads)
        plain = lambda: attention_kernel.mha_reference(q, k, v, heads)
        split = lambda t: t.view(Bq, t.shape[1], heads, -1).transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(split(q), split(k),
                                                     split(v))
        err = (kern() - plain()).abs().max().item()
        terms = bound_terms(4 * (2 * q.numel() + 2 * k.numel()),
                            f32_ops=4.0 * Bq * nq * nk * hd)
        record("attention", calls, err, timed(kern), timed(plain),
               timed(lib), terms, f"B={Bq} Nq={nq} Nk={nk} H={heads}")

    sa_mod = model.savi.slot_attention
    p = {key: val.detach().contiguous()
         for key, val in sa_mod.kernel_weights().items()}
    for (Bs, N, S, D, M, iters), calls in sorted(sa_calls.items()):
        ks = torch.randn(Bs, N, D, generator=gen, device=dev)
        vs = torch.randn(Bs, N, D, generator=gen, device=dev)
        s0 = torch.randn(Bs, S, D, generator=gen, device=dev)
        kw = dict(num_iterations=iters, eps=sa_mod.eps,
                  return_last_attn=True)
        kern = lambda: slot_attention_kernel.sa_iterations(ks, vs, s0, p,
                                                           **kw)
        plain = lambda: slot_attention_kernel.sa_iterations_ref(ks, vs, s0,
                                                                p, **kw)
        (ko, km), (po, pm) = kern(), plain()
        err = max((ko - po).abs().max().item(), (km - pm).abs().max().item())
        nbytes = (2 * Bs * N * D * 2 + 2 * Bs * S * D * 4 + Bs * S * N * 4 +
                  4 * (D * D + 6 * D * D + 2 * D * M))
        mm = 2.0 * Bs * iters * S
        terms = bound_terms(nbytes, bf16_ops=mm * 2 * N * D,
                            f32_ops=mm * D * (D + 6 * D + 2 * M))
        record("slot_attention", calls, err, timed(kern),
               timed(plain), None, terms,
               f"B={Bs} N={N} S={S} D={D} iters={iters}")
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
    for name, err in edge.items():
        ok = err <= TOL[name]
        log(f"phase 3: {name} ragged-edge shape: max_abs_err {err:.3e} "
            f"(tol {TOL[name]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} edge")
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")

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
    launches = ops.launch_counts()
    log(f"phase 4: launches on the serving path {launches}")
    missing = [k for k, n in launches.items() if n == 0]
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

    # ---- 5. report ------------------------------------------------------
    mods = {m.KERNEL_NAME: m for m in ops.KERNEL_MODULES}
    kernels = []
    for name, r in results.items():
        m = mods[name]
        kernels.append({
            "name": name, "route": m.ROUTE, "source": m.SOURCE,
            "replaces": f"{ops.REFERENCE_PACKAGE}/{m.REPLACES}",
            "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "event_ms": r["event"],
            "plain_ms": r["plain"],
            "bound_ms": max(r["t_bytes"], r["t_ops"]),
            "bound_by": ("bytes" if r["t_bytes"] >= r["t_ops"]
                         else "operations"),
            "library_ms": r["lib"] if r["has_lib"] else None,
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
