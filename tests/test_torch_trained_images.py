"""The port on the repo's trained image models, against the JAX package,
on the CPU: `checkpoint/sa_synthetic_long-res64/ckpt_final` (SA) and
`checkpoint/sa_ldm_synthetic_long-res64/ckpt_final` (SADiffusion) are
exported by `scripts/export_torch_checkpoint.py` (SADiffusion's EMA of
`dm_decoder` swapped in), loaded strictly into the port's
`SASyntheticLong64` and `SALDMSyntheticLong64`, and held against the JAX
models restored by `load_model_params` on the same inputs: `encode`, SA's
reconstruction, SADiffusion's losses at fixed t and noise and a
DPM-Solver++ sample with VQ decode; `Trainer.validate` and test_seg on
the 32 validation images against the JAX `seg_metrics_fn` on the same
batches; test_recon.

Both configs run slot attention with `use_pallas="auto"`: the f32
formula on the CPU, which is what the JAX models compute off the TPU.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.methods.build import seg_metrics_fn as jax_seg_metrics
from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.training.checkpoint import load_model_params
from slotdiffusion_tpu.utils import load_params
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import convert_model
from slotdiffusion_tpu_torch.data import build_datamodule, build_dataset
from slotdiffusion_tpu_torch.data.loader import epoch_batches, make_loader
from slotdiffusion_tpu_torch.data.synthetic import SyntheticImageDataset
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.training.checkpoint import load_model_weights
from torch_parity_helpers import t2n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {
    "sa": ("SASyntheticLong64", "configs/sa_synthetic_long-res64.py",
           "checkpoint/sa_synthetic_long-res64/ckpt_final"),
    "sa_ldm": ("SALDMSyntheticLong64",
               "configs/sa_ldm_synthetic_long-res64.py",
               "checkpoint/sa_ldm_synthetic_long-res64/ckpt_final"),
}
# f32 on both sides, the same formulas summed in another order
TOL = dict(rtol=1e-4, atol=1e-5)
# the metrics against JAX's on the same batches: the masks agree to ~1e-6,
# so an argmax flips only at an exact near-tie
VAL_METRIC_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch CPU threads: SA's decoder runs 6 broadcast passes a
    64x64 image through 5x5 deconvs (4.4 s for the 32 val images on one
    thread, twice), and beside other test processes more threads only
    contend for the cores."""
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
def trained(tmp_path_factory):
    """{"sa" | "sa_ldm": dict(pt, cfg, model (port, CPU, eval), jmodel,
    jvars)} for the two trained checkpoints."""
    export = _script("export_torch_checkpoint").export
    out = {}
    for key, (name, jcfg, ckpt) in MODELS.items():
        jcfg, ckpt = os.path.join(REPO, jcfg), os.path.join(REPO, ckpt)
        pt = str(tmp_path_factory.mktemp("export") / "model.pt")
        state = export(jcfg, ckpt, pt)
        assert state["config"] == name and state["ema"] == (key == "sa_ldm")
        cfg = configs.get_config(name)
        model = build_model(cfg, device="cpu")
        load_model_weights(model, pt)  # strict
        jparams = load_params(jcfg)
        jmodel = build_jax_model(jparams)
        out[key] = dict(pt=pt, cfg=cfg, model=model.eval(), jmodel=jmodel,
                        jvars=load_model_params(jmodel, ckpt, jparams))
    return out


def _jax(t, fn, *args):
    jm = t["jmodel"]
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=fn))(
        t["jvars"], *[jnp.asarray(a) for a in args])


def _images(n=4, seed=3):
    ds = SyntheticImageDataset(resolution=(64, 64), num_samples=n,
                               seed=seed)
    return np.stack([ds[i]["img"] for i in range(n)])


@pytest.mark.parametrize("key", ["sa", "sa_ldm"])
def test_export_loads_strictly_and_matches_the_checkpoint(trained, key):
    """Every port tensor comes from the checkpoint: the exported file
    equals `convert_model` of the restored (EMA-swapped) tree."""
    t = trained[key]
    want = convert_model(jax.tree_util.tree_map(
        np.asarray, t["jvars"]["params"]), t["cfg"])
    sd = t["model"].state_dict()
    assert set(want) == set(sd)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def test_sa_encode_and_reconstruction_match_jax(trained):
    """SA's slots, reconstruction, per-slot RGB and masks of 4 images, f32
    on both sides: rtol 1e-4 and, as tests/test_torch_trained.py's encode,
    atol 1e-4 (slots of magnitude ~7 after 3 iterations; measured 8.6e-6;
    the masks and image, measured 1.8e-5 and 2.0e-5, inherit a mask's
    error times a per-slot RGB of up to |73|). The per-slot RGB is held
    to 1e-5 of its scale: an invisible slot (alpha ~ 0) reaches |73|,
    where one f32 rounding is 4e-6 (measured 6.1e-5, 1e-6 of the
    scale)."""
    t, img = trained["sa"], _images()
    ref = _jax(t, lambda m, x: m({"img": x}, train=False), img)
    with torch.no_grad():
        out = t["model"]({"img": torch.from_numpy(img)})
    assert out["recon_img"].shape == (4, 64, 64, 3)
    for k in ("slots", "recon_img", "masks"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    want = np.asarray(ref["recons"])
    np.testing.assert_allclose(t2n(out["recons"]), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_sadiffusion_encode_and_losses_match_jax(trained):
    """SADiffusion's slots and masks of 4 images (rtol 1e-4, atol 1e-5),
    and the denoising loss at fixed timesteps and latent noise (rtol
    1e-4); the JAX side composes q_sample + denoise itself, as `make_rng`
    draws can never equal a torch.Generator's."""
    t, img = trained["sa_ldm"], _images()
    ref = _jax(t, lambda m, x: m({"img": x}, train=False), img)
    with torch.no_grad():
        out = t["model"]({"img": torch.from_numpy(img)})
    assert out["masks"].shape == (4, 6, 64, 64)
    for k in ("slots", "masks"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
    r = np.random.RandomState(4)
    tt = r.randint(0, 200, size=4).astype(np.int32)
    noise = r.randn(4, 32, 32, 3).astype(np.float32)

    def f(m, img, t, noise):
        out = m({"img": img}, train=True)
        dm = m.dm_decoder
        pred = dm.denoise(dm.q_sample(dm.encode_latent(img), t, noise), t,
                          context=out["slots"], train=False)
        return jnp.mean((pred - noise) ** 2)

    want = float(_jax(t, f, img, tt, noise))
    with torch.no_grad():
        _, losses = t["model"].compute_losses(
            {"img": torch.from_numpy(img)}, t=torch.from_numpy(tt).long(),
            noise=torch.from_numpy(noise), train=False)
    np.testing.assert_allclose(losses["denoise_loss"].item(), want,
                               rtol=1e-4)


def test_sadiffusion_sample_with_vq_decode_matches_jax(trained):
    """`log_images` by 3 DPM-Solver++ steps from the same x_T, then VQ
    decode, against the JAX model's encode -> `sample_dpm` ->
    `decode_latent`: no latent position changes code, and the images
    agree at rtol 1e-4, atol 1e-5."""
    t, img = trained["sa_ldm"], _images(2)
    x_T = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)

    def f(m, x, xt):
        dm = m.dm_decoder
        z = dm.sample_dpm(jax.random.PRNGKey(0),
                          cond=m({"img": x}, train=False)["slots"], steps=3,
                          x_T=xt)
        return dm.vae.quantize(z), dm.decode_latent(z)

    q_ref, img_ref = _jax(t, f, img, x_T)
    with torch.no_grad():
        got = t["model"].log_images({"img": torch.from_numpy(img)}, steps=3,
                                    x_T=torch.from_numpy(x_T))
    # the final latents' codes: decoding them again must give the samples
    dm = t["model"].dm_decoder
    with torch.no_grad():
        img_q = dm.decode_latent(torch.from_numpy(np.array(q_ref)))
    np.testing.assert_array_equal(t2n(img_q), t2n(got["samples"]))
    np.testing.assert_allclose(t2n(got["samples"]), np.asarray(img_ref),
                               **TOL)


def _val_batches(cfg):
    val = build_dataset(cfg)[1]
    return list(make_loader(val, epoch_batches(len(val), cfg.val_batch_size,
                                               drop_last=False)))


def _jax_val_metrics(t, batches):
    fwd = jax.jit(lambda v, x: t["jmodel"].apply(v, {"img": x}, train=False))
    sums, n = {}, 0
    for batch in batches:
        out = jax.device_get(fwd(t["jvars"], batch["img"].numpy()))
        m = jax_seg_metrics({"masks": batch["masks"].numpy()}, out)
        bs = batch["img"].shape[0]
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v * bs
        n += bs
    return {k: v / n for k, v in sums.items()}


@pytest.mark.parametrize("key", ["sa", "sa_ldm"])
def test_validate_and_test_seg_match_jax(trained, key, capsys, tmp_path):
    """`Trainer.validate` and `scripts/test_seg_torch.py` on the config's
    32 validation images: FG-ARI, ARI, mIoU, FG-mIoU and mBO within 1e-4
    of the JAX `seg_metrics_fn` on the JAX model's outputs for the same
    batches; the live weights bit-identical after validate; then
    `scripts/test_recon_torch.py` on one batch (finite MSE, PSNR,
    SSIM)."""
    t = trained[key]
    cfg = t["cfg"].copy(num_workers=0)
    batches = _val_batches(cfg)
    assert sum(b["img"].shape[0] for b in batches) == 32
    want = _jax_val_metrics(t, batches)
    model = t["model"]
    trainer = build_method(model, build_datamodule(cfg), cfg)
    live = {k: v.clone() for k, v in model.state_dict().items()}
    res = trainer.validate()
    for k, v in model.state_dict().items():
        assert torch.equal(v, live[k]), k
    loss = "img_recon_loss" if key == "sa" else "denoise_loss"
    assert np.isfinite(res[f"val/{loss}"])
    common = ["--params", t["cfg"].__class__.__name__, "--weight", t["pt"],
              "--cpu", "--num_workers", "0"]
    seg = _script("test_seg_torch").main(common + ["--split", "val"])[0]
    out = capsys.readouterr().out
    assert f"{common[1]}, L=full" in out and out.count("FINAL ari=") == 1
    for k, w in want.items():
        assert abs(res[f"val/{k}"] - w) <= VAL_METRIC_TOL, \
            (k, res[f"val/{k}"], w)
        assert abs(seg[k] - w) <= VAL_METRIC_TOL, (k, seg[k], w)
    rec = _script("test_recon_torch").main(
        common + ["--bs", "2", "--max_batches", "1", "--out_dir",
                  str(tmp_path)])
    assert set(rec) == {"mse", "psnr", "ssim"} and \
        all(np.isfinite(v) for v in rec.values())
