"""The port on the repo's trained baselines, against the JAX package, on
the CPU: `checkpoint/savi_synthetic_params-res64/ckpt_last` (SAVi),
`checkpoint/dvae_synthetic_long-res64/ckpt_final` (the dVAE),
`checkpoint/slate_synthetic_long-res64/ckpt_final` (SLATE) and
`checkpoint/steve_synthetic_long-res64/ckpt_final` (STEVE) are exported
by `scripts/export_torch_checkpoint.py`, loaded strictly into the port's
`SAViSynthetic64`, `DVAESyntheticLong64`, `SLATESyntheticLong64` and
`STEVESyntheticLong64`, and held against the JAX models restored by
`load_model_params` on the same inputs: encode, the losses, SAVi's
reconstruction, the dVAE's tokens and decode, SLATE's and STEVE's AR
`recon_img` (the generated ids equal JAX's); `Trainer.validate` and
test_seg on the validation splits against the JAX `seg_metrics_fn` on
the same batches (within 1e-4); test_recon on a batch.

Every config runs slot attention with `use_pallas="auto"`: the f32
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
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.training.checkpoint import load_model_weights
from torch_parity_helpers import t2n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {
    "savi": ("SAViSynthetic64", "configs/savi_synthetic_params-res64.py",
             "checkpoint/savi_synthetic_params-res64/ckpt_last"),
    "dvae": ("DVAESyntheticLong64", "configs/dvae_synthetic_long-res64.py",
             "checkpoint/dvae_synthetic_long-res64/ckpt_final"),
    "slate": ("SLATESyntheticLong64", "configs/slate_synthetic_long-res64.py",
              "checkpoint/slate_synthetic_long-res64/ckpt_final"),
    "steve": ("STEVESyntheticLong64", "configs/steve_synthetic_long-res64.py",
              "checkpoint/steve_synthetic_long-res64/ckpt_final"),
}
# f32 on both sides, the same formulas summed in another order
TOL = dict(rtol=1e-4, atol=1e-5)
# the metrics against JAX's on the same batches: the masks agree to ~1e-6,
# so an argmax flips only at an exact near-tie
VAL_METRIC_TOL = 1e-4


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
def trained(tmp_path_factory):
    """{key: dict(pt, cfg, model (port, CPU, eval), jmodel, jvars)} of the
    four trained checkpoints."""
    export = _script("export_torch_checkpoint").export
    out = {}
    for key, (name, jcfg, ckpt) in MODELS.items():
        jcfg, ckpt = os.path.join(REPO, jcfg), os.path.join(REPO, ckpt)
        pt = str(tmp_path_factory.mktemp("export") / "model.pt")
        state = export(jcfg, ckpt, pt)
        assert state["config"] == name and not state["ema"]
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


def _val_batches(cfg, n=None):
    val = build_dataset(cfg)[1]
    batches = list(make_loader(val, epoch_batches(
        len(val), cfg.val_batch_size, drop_last=False)))
    return batches if n is None else batches[:n]


@pytest.mark.parametrize("key", sorted(MODELS))
def test_export_loads_strictly_and_matches_the_checkpoint(trained, key):
    """Every port tensor comes from the checkpoint: the exported file
    equals `convert_model` of the restored tree."""
    t = trained[key]
    want = convert_model(jax.tree_util.tree_map(
        np.asarray, t["jvars"]["params"]), t["cfg"])
    sd = t["model"].state_dict()
    assert set(want) == set(sd)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def test_savi_encode_and_reconstruction_match_jax(trained):
    """SAVi's slots, image, per-slot RGB and masks of 4 val clips of 3
    frames and their loss: rtol 1e-4, atol 1e-4 (slots of magnitude ~10
    after 2 iterations a frame, as the trained SA's), the loss rtol
    1e-5."""
    t = trained["savi"]
    img = _val_batches(t["cfg"].copy(val_batch_size=4), 1)[0]["img"]
    ref, losses = _jax(t, lambda m, x: m.compute_losses({"img": x}), img)
    with torch.no_grad():
        out, got = t["model"].compute_losses({"img": img})
    assert out["recon_img"].shape == (4, 3, 64, 64, 3)
    for k in ("slots", "recon_img", "masks"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["img_recon_loss"].item(),
                               float(losses["img_recon_loss"]), rtol=1e-5)


def test_dvae_tokens_and_decode_match_jax(trained):
    """The trained dVAE on 8 val frames: the token ids equal; the eval
    forward (the softmax of the log-probabilities at the final
    temperature 0.1, decoded) rtol 1e-4, atol 5e-4: dividing by 0.1 makes
    the logits' f32 differences ten times larger (measured 1.5e-4 on 4 of
    the 98,304 values, pixels of magnitude ~0.5)."""
    t = trained["dvae"]
    img = _val_batches(t["cfg"].copy(val_batch_size=8), 1)[0]["img"]
    ids = _jax(t, lambda m, x: m.tokenize(x, one_hot=False), img)
    out, _ = _jax(t, lambda m, x: m.compute_losses(
        {"img": x}, sched={"gumbel_tau": 0.1}, train=False), img)
    model = t["model"]
    with torch.no_grad():
        got_ids = model.tokenize(img, one_hot=False)
        _, losses = model.compute_losses({"img": img}, train=False,
                                         sched={"gumbel_tau": 0.1})
        recon = model({"img": img}, sched={"gumbel_tau": 0.1},
                      train=False)["recon"]
    assert got_ids.shape == (8, 1, 16, 16)
    np.testing.assert_array_equal(t2n(got_ids), np.asarray(ids))
    np.testing.assert_allclose(t2n(recon), np.asarray(out["recon"]),
                               rtol=1e-4, atol=5e-4)
    assert losses["recon_loss"].item() < 0.05


@pytest.mark.parametrize("key", ["slate", "steve"])
def test_token_models_losses_and_recon_img_match_jax(trained, key):
    """SLATE on 2 val images, STEVE on 2 val clips of 2 frames: the slots
    and masks, the token cross-entropy rtol 1e-5; `recon_img`'s greedy
    generation of 256 tokens a frame gives the JAX ids, and the decoded
    frames agree rtol 1e-4, atol 1e-4."""
    t = trained[key]
    img = _val_batches(t["cfg"].copy(val_batch_size=2), 1)[0]["img"]
    ref, losses = _jax(t, lambda m, x: m.compute_losses({"img": x}), img)
    with torch.no_grad():
        out, got = t["model"].compute_losses({"img": img})
    for k in ("slots", "masks"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["token_recon_loss"].item(),
                               float(losses["token_recon_loss"]), rtol=1e-5)
    slots = np.asarray(ref["slots"])
    flat = slots.reshape(-1, *slots.shape[-2:])
    ids, _ = _jax(t, lambda m, s: m.trans_decoder.generate(s, 256), flat)
    imgs = _jax(t, lambda m, s: m.recon_img(s), slots)
    model = t["model"]
    with torch.no_grad():
        got_ids, _ = model.trans_decoder.generate(torch.from_numpy(flat),
                                                  256)
    got = model.recon_img(torch.from_numpy(slots))
    np.testing.assert_array_equal(t2n(got_ids), np.asarray(ids))
    assert got.shape == img.shape
    np.testing.assert_allclose(t2n(got), np.asarray(imgs), rtol=1e-4,
                               atol=1e-4)


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


@pytest.mark.parametrize("key", ["savi", "slate", "steve"])
def test_validate_and_test_seg_match_jax(trained, key, capsys, tmp_path):
    """`Trainer.validate` and `scripts/test_seg_torch.py` (video: the
    training clip length, then the whole video in chunks with the slots
    carried over) on the config's validation split: FG-ARI, ARI, mIoU,
    FG-mIoU and mBO within 1e-4 of the JAX `seg_metrics_fn` on the JAX
    model's outputs for the same batches; the live weights bit-identical
    after validate; then `scripts/test_recon_torch.py` on one batch
    (finite MSE, PSNR, SSIM)."""
    t = trained[key]
    cfg = t["cfg"].copy(num_workers=0)
    want = _jax_val_metrics(t, _val_batches(cfg))
    model = t["model"]
    trainer = build_method(model, build_datamodule(cfg), cfg)
    live = {k: v.clone() for k, v in model.state_dict().items()}
    res = trainer.validate()
    for k, v in model.state_dict().items():
        assert torch.equal(v, live[k]), k
    loss = "img_recon_loss" if key == "savi" else "token_recon_loss"
    assert np.isfinite(res[f"val/{loss}"])
    name = cfg.__class__.__name__
    common = ["--params", name, "--weight", t["pt"], "--cpu",
              "--num_workers", "0"]
    sweep = ["--seq_len", str(cfg.n_sample_frames), "-1"] \
        if key != "slate" else []
    seg = _script("test_seg_torch").main(common + ["--split", "val"] +
                                         sweep)
    out = capsys.readouterr().out
    assert out.count("FINAL ari=") == len(seg) == (1 if key == "slate"
                                                   else 2)
    for k, w in want.items():
        assert abs(res[f"val/{k}"] - w) <= VAL_METRIC_TOL, \
            (k, res[f"val/{k}"], w)
        assert abs(seg[0][k] - w) <= VAL_METRIC_TOL, (k, seg[0][k], w)
    assert all(np.isfinite(v) for v in seg[-1].values())
    rec = _script("test_recon_torch").main(
        common + ["--bs", "2", "--max_batches", "1", "--out_dir",
                  str(tmp_path)])
    assert set(rec) == {"mse", "psnr", "ssim"} and \
        all(np.isfinite(v) for v in rec.values())
