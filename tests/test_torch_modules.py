"""Modules of the PyTorch port against the JAX package, on the CPU.

A tiny SAViDiffusion of the flagship's structure (tests/
torch_parity_helpers.py) is given seeded weights; `slotdiffusion_tpu_torch.
convert` carries them into the port (a strict `load_state_dict`, so every
parameter is mapped), and each submodule gets the same numpy inputs on
both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slotdiffusion_tpu.methods.inference import \
    chunked_video_apply as jax_chunked
from slotdiffusion_tpu.models.slot_diffusion import \
    _upsample_masks as jax_upsample_masks
from slotdiffusion_tpu.ops.dpm_solver import \
    dpm_solver_sample as jax_dpm_sample
from slotdiffusion_tpu_torch.methods.inference import chunked_video_apply
from slotdiffusion_tpu_torch.models.slot_diffusion import _upsample_masks
from slotdiffusion_tpu_torch.models.unet import Dropout, Upsample
from slotdiffusion_tpu_torch.ops.dpm_solver import dpm_solver_sample
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, build_pair, t2n,
                                  video)

# f32 on both sides with the same formulas; convolutions and sums run in
# another order, so outputs of O(1) differ by a few f32 ulps per layer
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    return build_pair(use_pallas=False)


def _apply(pair, fn, *args):
    _, jmodel, jvars, _ = pair
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, method=fn))(
        jvars, *[jnp.asarray(a) for a in args])


def test_unet_matches_jax(pair):
    r = np.random.RandomState(1)
    x = r.randn(2, 4, 4, 3).astype(np.float32)
    t = np.array([3.0, 41.5], np.float32)
    ctx = r.randn(2, SLOTS, SLOT_SIZE).astype(np.float32)
    ref = _apply(pair, lambda m, x, t, c: m.dm_decoder.unet(x, t, c),
                 x, t, ctx)
    with torch.no_grad():
        out = pair[3].dm_decoder.unet(
            torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
            torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


def test_vqvae_encode_quantize_decode_match_jax(pair):
    img = video(2)
    vae = pair[3].dm_decoder.vae
    z_ref = _apply(pair, lambda m, x: m.dm_decoder.vae.encode(x), img)
    q_ref = _apply(pair, lambda m, z: m.dm_decoder.vae.quantize(z), z_ref)
    x_ref = _apply(pair, lambda m, z: m.dm_decoder.vae.decode(z), z_ref)
    with torch.no_grad():
        z = vae.encode(torch.from_numpy(img))
        q = vae.quantize(torch.from_numpy(np.array(z_ref)))
        x = vae.decode(torch.from_numpy(np.array(z_ref)))
    np.testing.assert_allclose(t2n(z), np.asarray(z_ref), **TOL)
    # same latents in: the nearest codes must be the same ones
    np.testing.assert_array_equal(t2n(q), np.asarray(q_ref))
    np.testing.assert_allclose(t2n(x), np.asarray(x_ref), **TOL)


def test_sa_encoder_matches_jax(pair):
    img = video(3)[:, 0]
    ref, ref_res = _apply(pair, lambda m, x: m.savi.encoder(x), img)
    with torch.no_grad():
        out, res = pair[3].savi.encoder(torch.from_numpy(img))
    assert tuple(res) == tuple(ref_res) == (RES[0] // 4, RES[1] // 4)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


def test_predictor_matches_jax(pair):
    s = np.random.RandomState(4).randn(2, SLOTS, SLOT_SIZE).astype(
        np.float32)
    ref, _ = _apply(pair, lambda m, s: m.savi.predictor(s), s)
    with torch.no_grad():
        out = pair[3].savi.predictor(torch.from_numpy(s))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_slot_attention_module_matches_jax(pair, use_pallas):
    """The JAX module off the TPU runs the f32 formula; the port's kernel
    path (`use_pallas=True`) rounds k, v, q and the attention weights to
    bf16 as the kernel does, which moves slots by ~1e-4 (relative 2^-8 on
    a few terms), hence its looser tolerance."""
    r = np.random.RandomState(5)
    feats = r.randn(2, 16, SLOT_SIZE).astype(np.float32)
    init = r.randn(2, SLOTS, SLOT_SIZE).astype(np.float32)
    ref, ref_mask = _apply(pair, lambda m, f, s: m.savi.slot_attention(f, s),
                           feats, init)
    sa = pair[3].savi.slot_attention
    sa.use_pallas = use_pallas
    try:
        with torch.no_grad():
            out, mask = sa(torch.from_numpy(feats), torch.from_numpy(init))
    finally:
        sa.use_pallas = False
    tol = TOL if not use_pallas else dict(rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), **tol)
    np.testing.assert_allclose(t2n(mask), np.asarray(ref_mask), **tol)


@pytest.mark.parametrize("steps", [3, 4, 5, 20])
def test_dpm_solver_matches_jax(steps):
    """Singlestep DPM-Solver++ order 3 on a fixed smooth model: steps
    3/4/5 end the order pattern on [2, 1], [1] and [2]."""
    betas = np.linspace(0.0015 ** 0.5, 0.0195 ** 0.5, 1000) ** 2
    x_T = np.random.RandomState(6).randn(2, 4, 4, 3).astype(np.float32)

    def model(xp):
        return lambda x, t: 0.3 * x + xp.sin(x) * t

    ref = jax_dpm_sample(model(jnp), betas, jnp.asarray(x_T), steps=steps,
                         order=3, correcting_x0_fn=lambda x: jnp.clip(
                             x, -1.5, 1.5))
    out = dpm_solver_sample(model(torch), betas, torch.from_numpy(x_T),
                            steps=steps, order=3,
                            correcting_x0_fn=lambda x: x.clamp(-1.5, 1.5))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


def test_upsample_phase_conv_equals_nearest_conv():
    """The phase-conv Upsample is nearest-2x + conv3x3 rewritten: equal to
    f32 rounding."""
    torch.manual_seed(0)
    up = Upsample(8)
    x = torch.randn(2, 8, 5, 6)
    with torch.no_grad():
        direct = up.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        np.testing.assert_allclose(t2n(up(x)), t2n(direct), **TOL)


def test_mask_upsample_matches_jax():
    m = np.random.RandomState(7).rand(2, SLOTS, 16).astype(np.float32)
    ref = jax_upsample_masks(jnp.asarray(m), (4, 4), RES)
    out = _upsample_masks(torch.from_numpy(m), (4, 4), RES)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


def test_chunked_video_apply_matches_jax():
    """5 frames in chunks of 2: two full chunks and a padded tail, with
    the last slots of a chunk seeding the next."""
    img = np.random.RandomState(8).rand(1, 5, 2, 2, 3).astype(np.float32)

    def apply(xp, cat):
        def fn(chunk, prev):
            base = chunk.sum((2, 3, 4))[..., None]  # [B, T, 1]
            carry = 0.0 if prev is None else prev[:, None, :1]
            slots = cat([base + carry, base * 2], -1)
            return {"slots": slots, "feat": chunk[..., 0]}
        return fn

    ref = jax_chunked(apply(np, np.concatenate), img, 2)
    out = chunked_video_apply(apply(torch, torch.cat), torch.from_numpy(img),
                              2)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(t2n(out[k]), ref[k], **TOL)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_rate_scale_and_eval_identity(p):
    """The UNet's dropout (the flagship's rate is 0.1). Its masks come from
    the run's torch.Generator, which can never equal JAX's `make_rng` bits,
    so the parity tests run at rate 0; this holds the module alone. In
    train mode the share of dropped values over 200,000 is within 5
    binomial standard deviations of p; every kept value is x / (1 - p),
    flax's nn.Dropout scaling; the same seed gives the same mask and
    another seed another. In eval mode, and at rate 0, it is the identity,
    and in train mode it needs a generator."""
    n = 200_000
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        0.5, 2.0, n).astype(np.float32))
    drop = Dropout(p).train()
    y = drop(x, torch.Generator().manual_seed(0))
    dropped = y == 0
    assert abs(dropped.float().mean().item() - p) <= \
        5 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(y[~dropped], x[~dropped] / (1 - p))
    assert torch.equal(y, drop(x, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, drop(x, torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError):
        drop(x)
    assert drop.eval()(x) is x
    assert Dropout(0.0).train()(x) is x
