"""The port on the repo's trained video-prediction and VQA models, against
the JAX package, on the CPU. `scripts/export_torch_checkpoint.py` carries
`checkpoint/slotformer_synthetic_params/ckpt_last` (SlotFormer),
`checkpoint/ldmslotformer_synthetic_long3-res64/ckpt_final`
(LDMSlotFormer), `checkpoint/readout_synthetic_params/ckpt_last` and
`checkpoint/readout_synthetic_rollout_long/ckpt_final` (the readouts)
into the port, loaded strictly; the JAX models are restored by
`load_model_params` once a module. On the same inputs:

- SlotFormer and LDMSlotFormer: rollouts (twice the trained length) and
  the eval losses on validation batches, within TOL;
- LDMSlotFormer's decode of rolled-out slots from a shared x_T (the full
  default DPM-Solver++ of `generate_imgs`, one noise shared, then the VQ
  decode): no latent position changes code, frames within TOL;
- the readouts' logits and accuracies on their validation splits, and
  test_physion_vqa's sweep against the same sweep of the JAX logits;
- `rollout_physion_slots_torch.py` on a few videos against the JAX
  rollouts; `test_vp_torch.py` on one batch;
- the graft: the raw dm_decoder of the exported savi_ldm long3 run is
  the trained LDMSlotFormer's decoder bit for bit (not its EMA);
- the params run's rollouter (its checkpoint's VQ-VAE is in flax's old
  automatic names, which the JAX package cannot apply either).
"""

import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.methods.inference import \
    interleaved_rollout as jax_interleaved
from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.training.checkpoint import load_model_params
from slotdiffusion_tpu.utils import load_params
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import (convert_diffusion,
                                             convert_model,
                                             convert_slot_rollouter)
from slotdiffusion_tpu_torch.data import build_dataset
from slotdiffusion_tpu_torch.data.loader import epoch_batches, make_loader
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.models.slotformer import SlotRollouter
from slotdiffusion_tpu_torch.training.checkpoint import (graft_pretrained,
                                                         load_model_weights)
from torch_parity_helpers import t2n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# key: (port config, JAX config, checkpoint, export key)
MODELS = {
    "slotformer": ("SlotFormerSynthetic", "configs/slotformer_synthetic_"
                   "params.py", "checkpoint/slotformer_synthetic_params/"
                   "ckpt_last"),
    "ldmslotformer": ("LDMSlotFormerSynthetic64Long3",
                      "configs/ldmslotformer_synthetic_long3-res64.py",
                      "checkpoint/ldmslotformer_synthetic_long3-res64/"
                      "ckpt_final"),
    "readout": ("ReadoutSynthetic", "configs/readout_synthetic_params.py",
                "checkpoint/readout_synthetic_params/ckpt_last"),
    "readout_rollout": ("ReadoutSyntheticRolloutLong",
                        "configs/readout_synthetic_rollout_long.py",
                        "checkpoint/readout_synthetic_rollout_long/"
                        "ckpt_final"),
}
# f32 on both sides, the same formulas summed in another order
TOL = dict(rtol=1e-4, atol=1e-5)


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


def _port_config(name):
    """The port config with its pickles' paths made absolute."""
    cfg = configs.get_config(name)
    for k in ("slots_root", "rollout_root"):
        if hasattr(cfg, k):
            setattr(cfg, k, os.path.join(REPO, getattr(cfg, k)))
    return cfg.copy(num_workers=0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """{key: dict(pt, cfg, model (port, CPU, eval), jmodel, jvars)}."""
    export = _script("export_torch_checkpoint").export
    out = {}
    for key, (name, jcfg, ckpt) in MODELS.items():
        jcfg, ckpt = os.path.join(REPO, jcfg), os.path.join(REPO, ckpt)
        pt = str(tmp_path_factory.mktemp("export") / "model.pt")
        state = export(jcfg, ckpt, pt)
        assert state["config"] == name and not state["ema"]
        cfg = _port_config(name)
        model = build_model(cfg, device="cpu")
        load_model_weights(model, pt)  # strict
        jparams = load_params(jcfg)
        jmodel = build_jax_model(jparams)
        out[key] = dict(pt=pt, cfg=cfg, model=model.eval(), jmodel=jmodel,
                        jvars=load_model_params(jmodel, ckpt, jparams))
    return out


def _jax(t, fn, *args):
    jm = t["jmodel"]
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=fn))(t["jvars"],
                                                               *args)


def _val_batch(cfg, bs=16):
    val = build_dataset(cfg)[1]
    return next(iter(make_loader(val, epoch_batches(len(val), bs,
                                                    drop_last=False))))


@pytest.mark.parametrize("key", sorted(MODELS))
def test_export_loads_strictly_and_matches_the_checkpoint(trained, key):
    t = trained[key]
    want = convert_model(jax.tree_util.tree_map(
        np.asarray, t["jvars"]["params"]), t["cfg"])
    sd = t["model"].state_dict()
    assert set(want) == set(sd)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("key", ["slotformer", "ldmslotformer"])
def test_rollout_and_losses_match_jax(trained, key):
    """A validation batch: the rollout over twice the trained length from
    the first history frames, and the eval losses (slot MSE with the
    loss decay at 0.5, each step's MSE) within TOL."""
    t = trained[key]
    m, cfg = t["model"], t["cfg"]
    slots = _val_batch(cfg)["slots"]
    H, R = m.history_len, m.rollout_len
    jm = t["jmodel"]
    want = jax.jit(lambda v, x: jm.apply(v, x, 2 * R, method=jm.rollout))(
        t["jvars"], jnp.asarray(slots[:, :H].numpy()))
    sched = {"loss_decay_factor": 0.5}
    _, want_losses = jax.jit(lambda v, d: jm.apply(
        v, d, sched, False, method=jm.compute_losses))(
        t["jvars"], {"slots": jnp.asarray(slots.numpy())})
    with torch.no_grad():
        got = m.rollout(slots[:, :H], 2 * R)
        _, losses = m.compute_losses({"slots": slots}, sched=sched,
                                     train=False)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)
    assert set(losses) == set(want_losses)
    for k, v in want_losses.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4,
                                   err_msg=k)


def test_ldm_slotformer_decode_matches_jax(trained):
    """The rolled-out slots of one clip (4 frames) decoded from a shared
    x_T: the JAX `dm_decoder.generate_imgs(use_dpm=True, same_noise=True,
    x_T=...)` + `decode_latent` against the port's `decode`."""
    t = trained["ldmslotformer"]
    m = t["model"]
    slots = _val_batch(t["cfg"], bs=1)["slots"]
    with torch.no_grad():
        pred = m.rollout(slots[:, :m.history_len], m.rollout_len)
    cond = pred.reshape(-1, m.num_slots, m.slot_size).numpy()
    x_T = np.random.RandomState(7).randn(len(cond), 32, 32, 3).astype(
        np.float32)

    def jdecode(jm, c, x):
        dm = jm.dm_decoder
        z = dm.generate_imgs(jax.random.PRNGKey(0), cond=c, use_dpm=True,
                             same_noise=True, x_T=x)
        return dm.vae.quantize(z), dm.decode_latent(z)

    q_ref, img_ref = _jax(t, jdecode, jnp.asarray(cond), jnp.asarray(x_T))
    with torch.no_grad():
        img = m.decode(torch.from_numpy(cond), x_T=torch.from_numpy(x_T))
        z = m.dm_decoder.sample_dpm(cond=torch.from_numpy(cond),
                                    x_T=torch.from_numpy(x_T))
        q = m.dm_decoder.vae.quantize(z)
    flipped = np.any(t2n(q) != np.asarray(q_ref), axis=-1).mean()
    assert flipped == 0.0, f"{flipped:.2%} of latent positions changed code"
    assert img.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(t2n(img), np.asarray(img_ref), **TOL)


@pytest.mark.parametrize("key", ["readout", "readout_rollout"])
def test_readout_matches_jax_on_its_validation_split(trained, key):
    """Every validation batch: the logits within TOL and the accuracies
    and loss as the JAX model's."""
    t = trained[key]
    cfg, m, jm = t["cfg"], t["model"], t["jmodel"]
    val = build_dataset(cfg)[1]
    fwd = jax.jit(lambda v, d: jm.apply(v, d, None, False,
                                        method=jm.compute_losses))
    for batch in make_loader(val, epoch_batches(len(val), 64,
                                                drop_last=False)):
        out_j, want = fwd(t["jvars"], {"slots": batch["slots"].numpy(),
                                       "label": batch["label"].numpy()})
        with torch.no_grad():
            out, got = m.compute_losses(batch, train=False)
        np.testing.assert_allclose(t2n(out["logits"]),
                                   np.asarray(out_j["logits"]), **TOL)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-5,
                                       err_msg=k)


def test_physion_vqa_script_matches_the_jax_sweep(trained):
    """test_physion_vqa_torch.py on the rollout readout's test split: the
    best threshold and accuracy and the per-task accuracies of the same
    sweep over the JAX model's probabilities."""
    t = trained["readout_rollout"]
    res = _script("test_physion_vqa_torch").main([
        "--params", "ReadoutSyntheticRolloutLong", "--weight", t["pt"],
        "--cpu", "--num_workers", "0", "--slots_root",
        t["cfg"].rollout_root])
    test = build_dataset(t["cfg"].copy(subset="test"), val_only=True)
    batch = next(iter(make_loader(test, epoch_batches(len(test), len(test),
                                                      drop_last=False))))
    jm = t["jmodel"]
    logits = np.asarray(jax.jit(lambda v, s: jm.apply(
        v, {"slots": s}, train=False)["logits"])(
        t["jvars"], batch["slots"].numpy()))
    probs = 1.0 / (1.0 + np.exp(-logits))
    labels, tasks = batch["label"].numpy(), batch["task_idx"].numpy()
    best = max(((float(((probs > th) == (labels > 0.5)).mean()), -i, th)
                for i, th in enumerate(
                    _script("test_physion_vqa_torch").THRESHOLDS)))
    assert res["acc"] == pytest.approx(best[0], abs=1e-6)
    assert res["threshold"] == best[2]
    for ti, name in enumerate(test.all_tasks):
        sel = tasks == ti
        want = float(((probs[sel] > best[2]) == (labels[sel] > 0.5)).mean())
        assert res["per_task"][name] == pytest.approx(want, abs=1e-6)


def test_rollout_script_matches_jax(trained, tmp_path):
    """rollout_physion_slots_torch.py on 3 validation videos of the
    extraction pickle: the layout of the JAX script's pickle, and the
    rollouts within TOL of the JAX `interleaved_rollout` of the JAX
    model."""
    t = trained["ldmslotformer"]
    with open(t["cfg"].slots_root, "rb") as f:
        full = pickle.load(f)
    small = {s: {k: full[s][k] for k in ("0", "1", "2")}
             for s in ("train", "val")}
    src, dst = str(tmp_path / "slots.pkl"), str(tmp_path / "rollout.pkl")
    with open(src, "wb") as f:
        pickle.dump(small, f)
    _script("rollout_physion_slots_torch").main([
        "--params", "LDMSlotFormerSynthetic64Long3", "--weight", t["pt"],
        "--save_path", dst, "--obs_frames", "4", "--slots_root", src,
        "--cpu", "--num_workers", "0"])
    with open(dst, "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == ["_meta", "test", "train", "val"]
    assert got["_meta"] == dict(max_objects=4, seed=0,
                                params="LDMSlotFormerSynthetic64Long3")
    jm = t["jmodel"]
    roll = jax.jit(lambda v, x, n: jm.apply(v, x, n, method=jm.rollout),
                   static_argnums=2)
    x = np.stack([small["val"][k] for k in ("0", "1", "2")])
    want = jax_interleaved(
        x, lambda p, n: np.asarray(roll(t["jvars"], jnp.asarray(p), n)), 4,
        4, 1)
    for i, k in enumerate(("0", "1", "2")):
        assert got["val"][k].dtype == np.float32
        np.testing.assert_allclose(got["val"][k], want[i], **TOL)


def test_vp_script_runs_on_one_batch(trained):
    """test_vp_torch.py: rollouts decoded and scored (MSE, PSNR, SSIM)."""
    t = trained["ldmslotformer"]
    res = _script("test_vp_torch").main([
        "--params", "LDMSlotFormerSynthetic64Long3", "--weight", t["pt"],
        "--bs", "1", "--max_batches", "1", "--cpu", "--num_workers", "0",
        "--slots_root", t["cfg"].slots_root])
    assert set(res) == {"mse", "psnr", "ssim"}
    assert all(np.isfinite(v) for v in res.values()) and res["psnr"] > 5


def test_graft_takes_the_raw_decoder_of_the_savi_ldm_run(trained,
                                                         tmp_path):
    """The exported savi_ldm long3 run (its raw dm_decoder) grafted by
    `dm_ckp_path` gives the trained LDMSlotFormer's decoder bit for bit,
    as the JAX `apply_pretrained` gave it; the run's EMA differs."""
    export = _script("export_torch_checkpoint")
    jcfg, ckpt, _ = export.DEFAULTS["savi_ldm_long3"]
    pt = str(tmp_path / "savi.pt")
    export.export(os.path.join(REPO, jcfg), os.path.join(REPO, ckpt), pt,
                  use_ema=False)
    t = trained["ldmslotformer"]
    cfg = t["cfg"].copy(dec_dict=dict(t["cfg"].dec_dict, dm_ckp_path=pt))
    model = build_model(cfg, device="cpu")
    assert graft_pretrained(model, cfg)
    got = {k: v for k, v in model.state_dict().items()
           if k.startswith("dm_decoder.")}
    want = t["model"].state_dict()
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    jparams = load_params(os.path.join(REPO, jcfg))
    ema = load_model_params(build_jax_model(jparams), os.path.join(
        REPO, ckpt), jparams)["params"]["dm_decoder"]
    ema = convert_diffusion(jax.tree_util.tree_map(np.asarray, ema),
                            cfg.dec_dict)
    assert any(not np.array_equal(v, t2n(got[f"dm_decoder.{k}"]))
               for k, v in ema.items())


def test_params_run_rollouter_matches_jax():
    """The params run's rollouter (its VQ-VAE is in flax's old automatic
    names, which neither package applies): converted strictly, a rollout
    of 8 steps within TOL."""
    jcfg = os.path.join(REPO, "configs/ldmslotformer_synthetic_params-"
                        "res64.py")
    jparams = load_params(jcfg)
    jm = build_jax_model(jparams)
    jv = load_model_params(jm, os.path.join(
        REPO, "checkpoint/ldmslotformer_synthetic_params-res64/ckpt_final"),
        jparams)
    rd = dict(configs.LDMSlotFormerSynthetic64().rollout_dict)
    port = SlotRollouter(**rd)
    port.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in convert_slot_rollouter(
                              jv["params"]["rollouter"]).items()},
                         strict=True)
    x = np.random.RandomState(0).randn(3, 4, 6, 64).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, 8, method=jm.rollout))(
        jv, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x), 8)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)
