"""Compositional generation in the port (`slotdiffusion_tpu_torch/methods/
comp_gen.py`, `scripts/test_comp_gen_torch.py`) against the JAX package's
`scripts/test_comp_gen.py` on the CPU, and the SA / SAVi `decode` it
runs.

- `shuffle_slots` on [B, N, C] and [B, T, N, C] equals the JAX script's,
  exactly;
- SA's and SAVi's `decode(slots)` on tiny seeded weights, and the whole
  encode -> shuffle -> decode of the trained
  `checkpoint/sa_synthetic_long-res64/ckpt_final` (exported by
  `scripts/export_torch_checkpoint.py`) on 4 images, f32 on both sides;
- SADiffusion's and SAViDiffusion's decode (DPM-Solver++, the VQ
  decode) of shuffled slots on tiny seeded weights from one shared x_T:
  the JAX script's decode dispatch with that x_T;
- the script on the trained SA: the composed frames as PNGs and the
  native FID under its label.

f32 tolerances are `rtol=1e-4, atol=1e-5` unless a test says otherwise:
the same formulas summed in another order.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.models.diffusion import LDM as JaxLDM
from slotdiffusion_tpu.training.checkpoint import load_model_params
from slotdiffusion_tpu.utils import load_params
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.data.synthetic import SyntheticImageDataset
from slotdiffusion_tpu_torch.methods.comp_gen import (decode_slots,
                                                      encode_slots,
                                                      shuffle_slots)
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.ops import fid
from slotdiffusion_tpu_torch.training.checkpoint import load_model_weights
from slotdiffusion_tpu_torch.utils.png import to_uint8
from torch_parity_helpers import (SLOT_SIZE, SLOTS, T_FRAMES, build_pair,
                                  t2n, tiny_baseline_config,
                                  tiny_image_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
DPM = dict(steps=2, order=2)  # DPM-Solver's options in the decode test
SA_CFG = ("configs/sa_synthetic_long-res64.py",
          "checkpoint/sa_synthetic_long-res64/ckpt_final")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_comp_gen():
    return _script("test_comp_gen")


@pytest.mark.parametrize("shape", [(4, 5, 8), (3, 2, 6, 8), (1, 3, 4)])
def test_shuffle_slots_matches_jax(jax_comp_gen, shape):
    """Slot k of sample b comes from sample (b - k) mod B, on images' and
    videos' slots: equal to the JAX script's `shuffle_slots` bit for
    bit."""
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    got = t2n(shuffle_slots(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, jax_comp_gen.shuffle_slots(x))
    B, N = shape[0], shape[-2]
    for b in range(B):
        for k in range(N):
            np.testing.assert_array_equal(got[b, ..., k, :],
                                          x[(b - k) % B, ..., k, :])


@pytest.mark.parametrize("model", ["SA", "SAVi"])
def test_decode_matches_jax(model):
    """`decode(slots)` [BT, N, D] -> (image, per-slot RGB, masks) of SA
    (`models/sa.py:183` of the JAX package) and SAVi (`savi.py:158`) on
    tiny seeded weights."""
    cfg = tiny_image_config("SA") if model == "SA" else \
        tiny_baseline_config("SAVi")
    _, jm, jv, tm = build_pair(cfg=cfg)
    n = 4 if model == "SA" else 2 * T_FRAMES
    slots = np.random.RandomState(3).randn(n, SLOTS, SLOT_SIZE).astype(
        np.float32)
    want = jax.jit(lambda v, s: jm.apply(v, s, method=jm.decode))(
        jv, jnp.asarray(slots))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(slots))
    assert got[0].shape == (n, *cfg.resolution, 3)
    assert got[2].shape == (n, SLOTS, *cfg.resolution, 1)
    for g, w, name in zip(got, want, ("recon", "recons", "masks")):
        np.testing.assert_allclose(t2n(g), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def trained_sa(tmp_path_factory):
    """(port model on the CPU, the exported .pt, the JAX model, its
    variables) of the trained SA."""
    export = _script("export_torch_checkpoint").export
    jcfg, ckpt = (os.path.join(REPO, p) for p in SA_CFG)
    pt = str(tmp_path_factory.mktemp("sa") / "model.pt")
    export(jcfg, ckpt, pt)
    model = build_model(configs.SASyntheticLong64(), device="cpu")
    load_model_weights(model, pt)
    jparams = load_params(jcfg)
    jmodel = build_jax_model(jparams)
    return model.eval(), pt, jmodel, load_model_params(jmodel, ckpt,
                                                        jparams)


def _val_images(n=4):
    ds = SyntheticImageDataset(resolution=(64, 64), num_samples=n, seed=1)
    return np.stack([ds[i]["img"] for i in range(n)])


def test_comp_gen_of_the_trained_sa_matches_jax(trained_sa, jax_comp_gen):
    """encode -> shuffle -> the broadcast decoder of 4 val images of the
    trained SA, against the JAX script's `encode_fn`, `shuffle_slots`
    and SA branch of `decode`: slots and composed frames within 1e-4
    (slots of magnitude ~7 after 3 iterations, as
    tests/test_torch_trained_images.py holds them)."""
    model, _, jm, jv = trained_sa
    img = _val_images()
    slots = jax.jit(lambda v, x: jm.apply(v, {"img": x}, train=False)[
        "slots"])(jv, jnp.asarray(img))
    mixed = jax_comp_gen.shuffle_slots(np.asarray(slots))
    want = jax.jit(lambda v, s: jm.apply(
        v, s, method=lambda m, s: m.decode(s)[0]))(jv, jnp.asarray(mixed))
    params = configs.SASyntheticLong64()
    with torch.no_grad():
        got_slots = encode_slots(model, params, torch.from_numpy(img))
        got = decode_slots(model, params, shuffle_slots(got_slots))
    np.testing.assert_allclose(t2n(got_slots), np.asarray(slots), rtol=1e-4,
                               atol=1e-4)
    assert got.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("model", ["SADiffusion", "SAViDiffusion"])
def test_diffusion_decode_of_shuffled_slots_matches_jax(jax_comp_gen, model):
    """`decode_slots` of shuffled seeded slots by DPM-Solver++ and the VQ
    decode, from an x_T given to both sides: the JAX script's decode of
    SADiffusion / SAViDiffusion (`generate_imgs(use_dpm=True)`, that is
    `sample_dpm`) with that x_T, on tiny seeded weights. Two steps of
    order 2 (the script's 20 of order 3 compile for ~55 s on the JAX
    side; the orders are held in tests/test_torch_samplers.py)."""
    cfg = tiny_image_config("SADiffusion") if model == "SADiffusion" else \
        None
    cfg, jm, jv, tm = build_pair(cfg=cfg)
    shape = (2, SLOTS, SLOT_SIZE) if model == "SADiffusion" else \
        (2, T_FRAMES, SLOTS, SLOT_SIZE)
    r = np.random.RandomState(7)
    slots = r.randn(*shape).astype(np.float32)
    mixed = jax_comp_gen.shuffle_slots(slots)
    flat = mixed.reshape(-1, SLOTS, SLOT_SIZE)
    dm = tm.dm_decoder
    x_T = r.randn(flat.shape[0], *dm.resolution, dm.channels).astype(
        np.float32)

    def dec(m, s, xt):  # the JAX script's `_dec`, given x_T
        x = m.dm_decoder.sample_dpm(jax.random.PRNGKey(0), cond=s,
                                    same_noise=True, x_T=xt, **DPM)
        assert isinstance(m.dm_decoder, JaxLDM)
        return m.dm_decoder.decode_latent(x)

    want = jax.jit(lambda v, s, xt: jm.apply(v, s, xt, method=dec))(
        jv, jnp.asarray(flat), jnp.asarray(x_T))
    with torch.no_grad():
        got = decode_slots(tm, cfg, shuffle_slots(torch.from_numpy(slots)),
                           x_T=torch.from_numpy(x_T), **DPM)
    assert got.shape == (flat.shape[0], *cfg.resolution, 3)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


def test_decode_slots_refuses_other_models():
    params = configs.ReadoutSynthetic()
    with pytest.raises(ValueError):
        decode_slots(None, params, torch.zeros(1, 2, 3))


def test_script_writes_composed_frames_and_fid(trained_sa, tmp_path,
                                               monkeypatch, capsys):
    """`scripts/test_comp_gen_torch.py` on the trained SA, one batch of 4
    val images, `--fid` on a seeded stand-in Inception and `--fvd` (an
    image model: no clip): 4 PNGs `000000.png`... holding the composed
    frames (PIL reads the port's writer), the FID line under
    `FID(untrained-weights)`. The Frechet distance of 2048-d features
    (scipy's sqrtm, ~15 s here) is replaced by a stand-in that records
    its inputs; the distance itself is held in
    tests/test_torch_fid_fvd.py."""
    model, pt, _, _ = trained_sa
    npz = fid.save_random_inception_npz(str(tmp_path / "inception.npz"))
    monkeypatch.setenv(fid.WEIGHTS_ENV, npz)
    monkeypatch.delenv("SLOTDIFFUSION_I3D_WEIGHTS", raising=False)
    seen = []
    monkeypatch.setattr(fid, "frechet_distance", lambda m1, s1, m2, s2: (
        seen.append((m1, s1, m2, s2)) or float(np.sum((m1 - m2) ** 2))))
    out_dir = tmp_path / "frames"
    res = _script("test_comp_gen_torch").main([
        "--params", "SASyntheticLong64", "--weight", pt, "--bs", "4",
        "--max_batches", "1", "--out_dir", str(out_dir), "--fid", "--fvd",
        "--cpu", "--num_workers", "0"])
    text = capsys.readouterr().out
    assert "WARNING: --fvd requested but SLOTDIFFUSION_I3D_WEIGHTS is " \
        "unset/missing; skipping native FVD" in text
    assert "native FID(untrained-weights) (composed vs real, 4 vs 4 " \
        "frames): " in text and res["frames"] == 4
    assert len(seen) == 1 and seen[0][0].shape == (fid.DIM,)
    params = configs.SASyntheticLong64()
    with torch.no_grad():
        want = decode_slots(model, params, shuffle_slots(encode_slots(
            model, params, torch.from_numpy(_val_images()))))
    want = to_uint8((want * 0.5 + 0.5).clamp(0, 1))
    assert sorted(os.listdir(out_dir)) == [f"{i:06d}.png" for i in range(4)]
    for i in range(4):
        got = np.asarray(Image.open(out_dir / f"{i:06d}.png"))
        np.testing.assert_array_equal(got, want[i])
