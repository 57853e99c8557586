"""The port's serving slice against the JAX package, on the CPU: a tiny
SAViDiffusion with the flagship's kernel knobs answers `encode`,
`denoise` and `sample` (DPM-Solver++ then VQ decode) on both sides with
the same weights and the same numpy inputs and noise."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu_torch.serving import build_serving_fn
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, T_FRAMES,
                                  build_pair, t2n, video)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides with the same formulas, summed in another order
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    return build_pair(use_pallas=True)


def _jax(pair, fn, *args):
    _, jmodel, jvars, _ = pair
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, method=fn))(
        jvars, *[jnp.asarray(a) for a in args])


def test_encode_matches_jax(pair):
    """The JAX model off the TPU runs slot attention in f32; the port's
    kernel path rounds k, v, q and the attention weights to bf16 (relative
    2^-8) as the kernel does, which moves slots and masks by ~1e-4."""
    img = video(0, B=2)
    ref = _jax(pair, lambda m, x: m({"img": x}, train=False), img)
    slots, masks = build_serving_fn(pair[3], "encode")(torch.from_numpy(img))
    assert slots.shape == (2, T_FRAMES, SLOTS, SLOT_SIZE)
    assert masks.shape == (2, T_FRAMES, SLOTS, *RES)
    tol = dict(rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(t2n(slots), np.asarray(ref["slots"]), **tol)
    np.testing.assert_allclose(t2n(masks), np.asarray(ref["masks"]), **tol)


def _inputs(seed=1, B=2):
    r = np.random.RandomState(seed)
    slots = r.randn(B, T_FRAMES, SLOTS, SLOT_SIZE).astype(np.float32)
    x = r.randn(B * T_FRAMES, RES[0] // 4, RES[1] // 4, 3).astype(
        np.float32)
    return slots, x


def test_denoise_matches_jax(pair):
    slots, x = _inputs()
    t = np.arange(x.shape[0], dtype=np.int32) * 11
    ref = _jax(pair, lambda m, x, t, c: m.dm_decoder.denoise(x, t, c),
               x, t, slots.reshape(-1, SLOTS, SLOT_SIZE))
    out = build_serving_fn(pair[3], "denoise")(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(slots))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


def test_sample_matches_jax(pair):
    """3 DPM-Solver++ steps (orders [2, 1]) from the same x_T, then VQ
    decode. Quantize-as-denoise takes an argmax over the codebook at every
    model call, so a rounding difference could flip a code: the test
    reports the share of latent positions whose final code differs before
    it compares the images."""
    slots, x_T = _inputs(2)
    cond = slots.reshape(-1, SLOTS, SLOT_SIZE)

    def jsample(m, c, x):
        z = m.dm_decoder.sample_dpm(jax.random.PRNGKey(0), cond=c, steps=3,
                                    x_T=x)
        return z, m.dm_decoder.vae.quantize(z), m.dm_decoder.decode_latent(z)

    z_ref, q_ref, img_ref = _jax(pair, jsample, cond, x_T)
    dm = pair[3].dm_decoder
    with torch.no_grad():
        z = dm.sample_dpm(cond=torch.from_numpy(cond), steps=3,
                          x_T=torch.from_numpy(x_T))
        q, img = dm.vae.quantize(z), dm.decode_latent(z)
    flipped = np.any(t2n(q) != np.asarray(q_ref), axis=-1).mean()
    assert flipped == 0.0, f"{flipped:.2%} of latent positions changed code"
    np.testing.assert_allclose(t2n(z), np.asarray(z_ref), **TOL)
    np.testing.assert_allclose(t2n(img), np.asarray(img_ref), **TOL)


def test_serving_surfaces(pair):
    """encode -> sample (seeded) -> denoise through the port's callables:
    shapes, finite values, a seed that steers and repeats."""
    model = pair[3]
    slots, masks = build_serving_fn(model, "encode")(
        torch.from_numpy(video(3, B=1)))
    sample = build_serving_fn(model, "sample")
    a, b, c = sample(5, slots), sample(5, slots), sample(6, slots)
    assert a.shape == (1, T_FRAMES, *RES, 3)
    assert torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    x = torch.randn(T_FRAMES, RES[0] // 4, RES[1] // 4, 3)
    out = build_serving_fn(model, "denoise")(
        x, torch.full((T_FRAMES,), 10.0), slots)
    assert out.shape == x.shape and torch.isfinite(out).all()
    logged = model.log_images(
        {"img": torch.from_numpy(video(3, B=1))},
        torch.Generator().manual_seed(0))
    assert logged["samples"].shape == (1, T_FRAMES, *RES, 3)


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Every module of the port (the scale-out package `parallel/` named
    among them), `chip_smoke.py`, and the training script run for one tiny
    step on the CPU, import neither jax, flax nor the JAX package."""
    code = ("import pkgutil, runpy, sys, slotdiffusion_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "
            "'.'):\n"
            "    __import__(m.name)\n"
            "need = {'slotdiffusion_tpu_torch.parallel.' + m for m in "
            "('distributed', 'mesh', 'tp')}\n"
            "assert need <= set(sys.modules), need - set(sys.modules)\n"
            "import chip_smoke\n"
            "sys.argv = ['train_torch.py', '--cpu', '--tiny', "
            f"'--max_steps', '1', '--ckp_path', {str(tmp_path)!r}]\n"
            "try:\n"
            "    runpy.run_path('scripts/train_torch.py', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "runpy.run_path('scripts/bench_torch_winograd.py')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'slotdiffusion_tpu')]\n"
            "assert not bad, bad\n")
    # the child takes this process's share of the cores (one thread under
    # a pytest-xdist worker, `torch_parity_helpers`)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300, env=dict(os.environ, OMP_NUM_THREADS=str(
                       torch.get_num_threads())))
    assert (tmp_path / "ckpt_last.pt").exists()


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result
    line (this host has no card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_kernel_inputs_are_what_the_kernels_take(pair, monkeypatch):
    """On the card each wrapper raises on an input its kernel does not take
    (layout, strides, dtype, sizes). The same checks run here on every
    kernel call of `encode` and `denoise`, of the f32 model and of the same
    weights built in bf16 (`use_bf16`), so a layout or dtype the serving
    path hands a kernel is caught without a card. The bf16 build hands GN
    and attention bf16 inputs (their bf16 entry points), slot attention
    its f32 k/v."""
    from slotdiffusion_tpu_torch.models import (blocks, build_model,
                                                slot_attention, unet)
    from slotdiffusion_tpu_torch.ops import (attention_kernel, fused_norm,
                                             slot_attention_kernel)
    from torch_parity_helpers import tiny_config
    calls = {"gn": 0, "mha": 0, "sa": 0}
    dtypes = {"gn": set(), "mha": set(), "sa": set()}

    def checked(name, check, fn, args_of):
        def wrapper(*args, **kwargs):
            inputs = args_of(*args, **kwargs)
            check(*inputs)
            calls[name] += 1
            dtypes[name].add(inputs[0].dtype)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(blocks, "fused_group_norm", checked(
        "gn", fused_norm.check_inputs, fused_norm.fused_group_norm,
        lambda x, w, b, g, eps=1e-5, act=None: (x, w, b, g, act)))
    monkeypatch.setattr(unet, "fused_mha", checked(
        "mha", attention_kernel.check_inputs, attention_kernel.fused_mha,
        lambda q, k, v, h, scale=None: (q, k, v, h)))
    monkeypatch.setattr(slot_attention, "sa_iterations", checked(
        "sa", slot_attention_kernel.check_inputs,
        slot_attention_kernel.sa_iterations,
        lambda k, v, s, p, num_iterations, kv_dtype=torch.bfloat16, **kw:
        (k, v, s, p, num_iterations, kv_dtype)))
    bf16 = build_model(tiny_config(use_bf16=True), device="cpu")
    bf16.load_state_dict(pair[3].state_dict(), strict=True)
    for model, dtype in ((pair[3], torch.float32), (bf16, torch.bfloat16)):
        for name in calls:
            calls[name] = 0
            dtypes[name].clear()
        slots, _ = build_serving_fn(model, "encode")(
            torch.from_numpy(video(4)))
        slots_in, x = _inputs(5, B=1)
        build_serving_fn(model, "denoise")(
            torch.from_numpy(x), torch.full((x.shape[0],), 3.0),
            torch.from_numpy(slots_in))
        assert calls["gn"] > 0 and calls["mha"] > 0 and calls["sa"] > 0, \
            calls
        assert dtypes == {"gn": {dtype}, "mha": {dtype},
                          "sa": {torch.float32}}, dtypes
