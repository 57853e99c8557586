"""The port on the repo's trained SAViDiffusion, against the JAX package,
on the CPU: `checkpoint/savi_ldm_movi_file-res64/ckpt_final` is exported
by `scripts/export_torch_checkpoint.py` (the EMA of `dm_decoder` swapped
in), loaded strictly into the port's `SAViLDMMoviFile64`, and held
against the JAX model restored by `load_model_params` on the same inputs:
`encode`, `compute_losses` at fixed t and noise, a DPM-Solver++ sample
with VQ decode, `Trainer.validate` on a generated MOVi tree, the
evaluation scripts, and the bf16 k/v of slot attention's kernel path
against the f32 formula on trained weights.

The config runs slot attention with `use_pallas="auto"`: the f32 formula
on the CPU, which is what the JAX model computes off the TPU."""

import importlib.util
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.data.movi import build_movi_dataset
from slotdiffusion_tpu.methods.build import seg_metrics_fn as jax_seg_metrics
from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.training.checkpoint import load_model_params
from slotdiffusion_tpu.utils import BaseParams, load_params
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import convert_savi_diffusion
from slotdiffusion_tpu_torch.data import build_datamodule, build_dataset
from slotdiffusion_tpu_torch.data.loader import epoch_batches, make_loader
from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoDataset
from slotdiffusion_tpu_torch.methods.build import (build_method,
                                                   seg_metrics_fn)
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.training.checkpoint import load_model_weights
from torch_parity_helpers import t2n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoint/savi_ldm_movi_file-res64/ckpt_final")
JAX_CONFIG = os.path.join(REPO, "configs/savi_ldm_movi_file-res64.py")
S, D = 6, 64
# f32 on both sides, the same formulas summed in another order
TOL = dict(rtol=1e-4, atol=1e-5)
# validate's metrics against JAX's on the same batches: the masks agree
# to ~1e-6, so an argmax flips only at an exact near-tie
VAL_METRIC_TOL = 1e-4
# slot attention's bf16 k/v against f32 on trained weights
ARGMAX_AGREEMENT, FARI_TOL = 0.999, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread for this file: its many small ops gain nothing
    from more, and beside other test processes more threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny MOVi tree: 3 train and 2 val videos of 6 frames, 64x64."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from gen_movi_tree import write_split
    root = tmp_path_factory.mktemp("movi")
    write_split(str(root), "E", "train", 3, 6, 64, 0)
    write_split(str(root), "E", "validation", 2, 6, 64, 1)
    old = os.environ.get("SLOTDIFFUSION_CACHE")
    os.environ["SLOTDIFFUSION_CACHE"] = str(root / "cache")
    yield str(root)
    if old is None:
        del os.environ["SLOTDIFFUSION_CACHE"]
    else:
        os.environ["SLOTDIFFUSION_CACHE"] = old


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """-> dict: the exported .pt, the port model loaded from it (CPU,
    eval), the JAX model with its EMA-swapped and raw variables."""
    pt = str(tmp_path_factory.mktemp("export") / "model.pt")
    state = _script("export_torch_checkpoint").export(JAX_CONFIG, CKPT, pt)
    assert state["config"] == "SAViLDMMoviFile64" and state["ema"]
    cfg = configs.SAViLDMMoviFile64()
    model = build_model(cfg, device="cpu")
    load_model_weights(model, pt)  # strict
    jparams = load_params(JAX_CONFIG)
    jmodel = build_jax_model(jparams)
    jvars = load_model_params(jmodel, CKPT, jparams)
    raw = load_model_params(jmodel, CKPT, jparams, use_ema=False)
    return dict(pt=pt, cfg=cfg, model=model.eval(), jmodel=jmodel,
                jvars=jvars, raw=raw)


def _clip(seed=3):
    """One seeded clip of 2 frames at 64x64 [1, 2, 64, 64, 3]."""
    return SyntheticVideoDataset(resolution=(64, 64), num_samples=1,
                                 n_sample_frames=2, seed=seed)[0]["img"][None]


def _jax(trained, fn, *args):
    jm = trained["jmodel"]
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=fn))(
        trained["jvars"], *[jnp.asarray(a) for a in args])


def test_export_loads_strictly_and_matches_the_checkpoint(trained):
    """Every port tensor comes from the checkpoint: the exported file
    equals `convert_savi_diffusion` of the restored EMA-swapped tree."""
    want = convert_savi_diffusion(
        jax.tree_util.tree_map(np.asarray, trained["jvars"]["params"]),
        trained["cfg"])
    sd = trained["model"].state_dict()
    assert set(want) == set(sd)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    n = sum(v.numel() for v in sd.values())
    assert 1.7e6 < n < 1.9e6, n


def test_encode_matches_jax(trained):
    """Slots and masks of one 2-frame clip, f32 on both sides: rtol 1e-4,
    atol 1e-4."""
    img = _clip()
    ref = _jax(trained, lambda m, x: m({"img": x}, train=False), img)
    with torch.no_grad():
        out = trained["model"]({"img": torch.from_numpy(img)})
    assert out["slots"].shape == (1, 2, S, D)
    assert out["masks"].shape == (1, 2, S, 64, 64)
    for k in ("slots", "masks"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_compute_losses_matches_jax(trained):
    """The denoising loss of the clip's 2 frames at fixed timesteps and
    latent noise: rtol 1e-4. The JAX side composes q_sample + denoise
    itself, as `make_rng` draws can never equal a torch.Generator's."""
    img = _clip()
    r = np.random.RandomState(4)
    t = r.randint(0, 200, size=2).astype(np.int32)
    noise = r.randn(2, 32, 32, 3).astype(np.float32)

    def f(m, img, t, noise):
        out = m({"img": img}, train=True)
        dm = m.dm_decoder
        x0 = dm.encode_latent(img.reshape(-1, *img.shape[2:]))
        pred = dm.denoise(dm.q_sample(x0, t, noise), t,
                          context=out["slots"].reshape(-1, S, D),
                          train=False)
        return jnp.mean((pred - noise) ** 2)

    want = float(_jax(trained, f, img, t, noise))
    with torch.no_grad():
        _, losses = trained["model"].compute_losses(
            {"img": torch.from_numpy(img)}, t=torch.from_numpy(t).long(),
            noise=torch.from_numpy(noise), train=False)
    np.testing.assert_allclose(losses["denoise_loss"].item(), want,
                               rtol=1e-4)


def test_sample_with_vq_decode_matches_jax(trained):
    """3 DPM-Solver++ steps from the same x_T, conditioned on the clip's
    JAX slots, then VQ decode: no latent position changes code (reported
    first), then the latents and images at rtol 1e-4, atol 1e-5."""
    slots = np.array(_jax(trained, lambda m, x: m({"img": x},
                                                  train=False)["slots"],
                          _clip())).reshape(-1, S, D)
    x_T = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)

    def jsample(m, c, x):
        z = m.dm_decoder.sample_dpm(jax.random.PRNGKey(0), cond=c, steps=3,
                                    x_T=x)
        return z, m.dm_decoder.vae.quantize(z), m.dm_decoder.decode_latent(z)

    z_ref, q_ref, img_ref = _jax(trained, jsample, slots, x_T)
    dm = trained["model"].dm_decoder
    with torch.no_grad():
        z = dm.sample_dpm(cond=torch.from_numpy(slots), steps=3,
                          x_T=torch.from_numpy(x_T))
        q, img = dm.vae.quantize(z), dm.decode_latent(z)
    flipped = np.any(t2n(q) != np.asarray(q_ref), axis=-1).mean()
    assert flipped == 0.0, f"{flipped:.2%} of latent positions changed code"
    np.testing.assert_allclose(t2n(z), np.asarray(z_ref), **TOL)
    np.testing.assert_allclose(t2n(img), np.asarray(img_ref), **TOL)


def _val_batches(tree, bs=8):
    cfg = configs.SAViLDMMoviFile64().copy(data_root=tree, num_workers=0)
    val = build_dataset(cfg)[1]
    return list(make_loader(val, epoch_batches(len(val), bs,
                                               drop_last=False)))


def _jax_val_metrics(trained, batches):
    """The JAX package's seg_metrics_fn on the JAX model's outputs for
    `batches`, averaged weighted by batch size."""
    fwd = jax.jit(lambda v, x: trained["jmodel"].apply(
        v, {"img": x}, train=False))
    sums, n = {}, 0
    for batch in batches:
        out = jax.device_get(fwd(trained["raw"], batch["img"].numpy()))
        m = jax_seg_metrics({"masks": batch["masks"].numpy()}, out)
        bs = batch["img"].shape[0]
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v * bs
        n += bs
    return {k: v / n for k, v in sums.items()}


@pytest.fixture(scope="module")
def jax_val(trained, tree):
    return _jax_val_metrics(trained, _val_batches(tree))


def test_validate_matches_jax_and_restores_the_live_weights(trained, tree,
                                                           jax_val):
    """`Trainer.validate` of the port model holding the checkpoint's raw
    parameters, its EMA shadow holding the checkpoint's EMA of dm_decoder
    (the JAX trainer's state): FG-ARI, ARI, mIoU, FG-mIoU and mBO within
    1e-4 of the JAX package's on the same batches; the live state_dict
    bit-identical afterwards; denoise_loss_ema from the EMA."""
    cfg = configs.SAViLDMMoviFile64().copy(data_root=tree, num_workers=0)
    model = build_model(cfg, device="cpu")
    raw = jax.tree_util.tree_map(np.asarray, trained["raw"]["params"])
    model.load_state_dict(convert_savi_diffusion(raw, cfg), strict=True)
    trainer = build_method(model, build_datamodule(cfg), cfg)
    ema = trained["model"].state_dict()
    for name in trainer.ema.shadow:
        trainer.ema.shadow[name].copy_(ema[name])
    live = {k: v.clone() for k, v in model.state_dict().items()}
    res = trainer.validate()
    for k, v in model.state_dict().items():
        assert torch.equal(v, live[k]), k
    assert not model.training
    for k, want in jax_val.items():
        assert abs(res[f"val/{k}"] - want) <= VAL_METRIC_TOL, \
            (k, res[f"val/{k}"], want)
    a, b = res["val/denoise_loss"], res["val/denoise_loss_ema"]
    assert np.isfinite(a) and np.isfinite(b) and a != b


def test_bf16_kv_on_trained_weights(trained, tree):
    """Slot attention's kernel path (`use_pallas=True`: on the CPU the
    kernel's plain twin, k/v/q/attention in bf16) against the f32 formula
    (`use_pallas=False`) on the trained weights and the val clips: the
    argmax slot agrees at >= 0.999 of the pixels and FG-ARI moves by
    <= 0.01. The measured values are printed."""
    model = trained["model"]
    sa = model.savi.slot_attention
    batches = _val_batches(tree)
    outs = {}
    try:
        for use in (True, False):
            sa.use_pallas = use
            with torch.no_grad():
                outs[use] = [model({"img": b["img"]}) for b in batches]
    finally:
        sa.use_pallas = "auto"
    agree = np.mean(np.concatenate([
        (a["masks"].argmax(2) == b["masks"].argmax(2)).numpy().ravel()
        for a, b in zip(outs[True], outs[False])]))
    fari = {use: np.mean([seg_metrics_fn(b, o)["fari"]
                          for b, o in zip(batches, outs[use])])
            for use in outs}
    print(f"bf16 k/v vs f32 on trained weights: argmax agreement "
          f"{agree:.6f}, FG-ARI {fari[True]:.6f} vs {fari[False]:.6f}")
    assert agree >= ARGMAX_AGREEMENT
    assert abs(fari[True] - fari[False]) <= FARI_TOL


def test_entry_points_on_the_tree(trained, tree, jax_val, tmp_path, capsys):
    """test_seg (`--seq_len 2 -1`; the 2-frame sweep gives the JAX
    package's metrics on the same clips), test_recon and extract_slots on
    the CPU with the exported .pt, printing or writing what their JAX
    counterparts do."""
    common = ["--params", "SAViLDMMoviFile64", "--weight", trained["pt"],
              "--data_root", tree, "--cpu", "--num_workers", "0"]
    seg = _script("test_seg_torch").main(
        common + ["--split", "val", "--seq_len", "2", "-1", "--bs", "8"])
    out = capsys.readouterr().out
    assert "SAViLDMMoviFile64, L=2" in out and \
        "SAViLDMMoviFile64, L=full" in out and out.count("FINAL ari=") == 2
    for k, want in jax_val.items():
        assert abs(seg[0][k] - want) <= VAL_METRIC_TOL, (k, seg[0][k], want)
    assert set(seg[1]) == set(jax_val) and \
        all(np.isfinite(v) for v in seg[1].values())

    rec = _script("test_recon_torch").main(
        common + ["--bs", "2", "--max_batches", "1"])
    out = capsys.readouterr().out
    assert "LPIPS, FID and FVD are not computed" in out and "FINAL mse=" in out
    assert set(rec) == {"mse", "psnr", "ssim"} and \
        all(np.isfinite(v) for v in rec.values())

    path = str(tmp_path / "slots.pkl")
    _script("extract_slots_torch").main(common + ["--save_path", path])
    with open(path, "rb") as f:
        slots = pickle.load(f)
    # the JAX script's layout: {split: {video folder name: [T, N, C]}}, a
    # split the tree lacks (test) skipped
    p = BaseParams()
    cfg = configs.SAViLDMMoviFile64().copy(data_root=tree)
    for k in ("dataset", "movi_level", "data_root", "resolution",
              "n_sample_frames", "frame_offset", "video_len", "load_mask"):
        setattr(p, k, getattr(cfg, k))
    jtrain, jval = build_movi_dataset(p)
    assert set(slots) == {"train", "val"}
    for split, ds in (("train", jtrain), ("val", jval)):
        assert sorted(slots[split]) == [os.path.basename(f)
                                        for f in ds.files]
        for v in slots[split].values():
            assert v.shape == (6, S, D) and v.dtype == np.float32
