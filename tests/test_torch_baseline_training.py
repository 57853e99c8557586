"""The port's token and reconstruction baselines against the JAX package,
on the CPU: training.

- `build_method` -> `Trainer` steps of SAVi, SLATE, STEVE and the dVAE
  (its gumbel temperature scheduled by the step) of tiny configs
  (tests/torch_parity_helpers.py:tiny_baseline_config) against the JAX
  losses and `optax.global_norm` on the same seeded weights and inputs,
  the decoder's LR group, the frozen dVAE, `validate`;
- `init_reference_` against flax's init for the new modules (the LSTM,
  the dVAE, the AR decoder).

The models' own parity is in tests/test_torch_baselines.py and
tests/test_torch_token_models.py. Both sides run slot attention's f32
formula (`use_pallas="auto"`).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slotdiffusion_tpu.models import blocks as jblocks
from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu_torch.convert import convert_model
from slotdiffusion_tpu_torch.data import build_datamodule
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.models import build_model, init_reference_
from torch_parity_helpers import (RES, SLOT_SIZE, VOCAB, build_pair, images,
                                  jax_params_of, tiny_baseline_config, video)

B = 2
H4 = RES[0] // 4  # the token map's side


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: this file's ops are small, and beside other
    test processes more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- build_method -> Trainer ---------------------------------------------

def _value_and_grad(jm, fn):
    vg = jax.jit(jax.value_and_grad(
        lambda p, *a: jm.apply({"params": p}, *a, method=fn)))
    return lambda params, *a: vg(params, *map(jnp.asarray, a))


def _trainer(cfg, tm, **over):
    cfg = cfg.copy(print_iter=1, num_workers=0, **over)
    model = copy.deepcopy(tm)
    return model, build_method(model, build_datamodule(cfg), cfg)


@pytest.mark.parametrize("family", ["SAVi", "SLATE", "STEVE"])
def test_trainer_step_and_grad_norm_match_jax(family):
    """One `Trainer.train_step` of each slot baseline: its loss and
    `train/grad_norm` against the JAX loss and `optax.global_norm` of
    its gradients, rtol 1e-5; SLATE and STEVE train `trans_decoder` at
    `dec_lr` in a group of its own and leave the dVAE as it was; then
    `fit` to 2 steps and `validate` (losses and, where the masks are at
    the ground truth's resolution, the segmentation metrics)."""
    cfg, jm, jv, tm = build_pair(cfg=tiny_baseline_config(family))
    # STEVE's 4x4 masks against 16x16 ground truth: the JAX trainer's
    # metrics fail there too, so its run validates without masks
    model, trainer = _trainer(cfg, tm, load_mask=family != "STEVE")
    x = images(5) if family == "SLATE" else video(5, B=B)
    loss = "img_recon_loss" if family == "SAVi" else "token_recon_loss"
    m = trainer.train_step({"img": torch.from_numpy(x)})
    value, grads = _value_and_grad(jm, lambda m, a: m.compute_losses(
        {"img": a})[1][loss])(jv["params"], x)
    np.testing.assert_allclose(m[f"train/{loss}"], float(value), rtol=1e-5)
    np.testing.assert_allclose(m["train/grad_norm"],
                               float(optax.global_norm(grads)), rtol=1e-5)
    groups = trainer.optimizer.adam.param_groups
    if family == "SAVi":
        assert len(groups) == 1
        frozen = {}
    else:
        assert sorted(g["lr"] for g in groups) == [0.0, 0.0]  # warmup
        assert len(groups) == 2
        frozen = {n: p.detach().clone()
                  for n, p in model.dvae.named_parameters()}
    trainer.fit(max_steps=2)
    assert trainer.step == 2
    for n, p in model.dvae.named_parameters() if frozen else ():
        assert not p.requires_grad and torch.equal(p, frozen[n]), n
    if family == "STEVE":
        res = trainer.validate()
        assert set(res) == {"val/token_recon_loss"}
        _, masked = _trainer(cfg, tm)
        with pytest.raises(ValueError, match="visual resolution"):
            masked.validate()
    else:
        res = trainer.validate()
        assert {f"val/{loss}", "val/fari", "val/miou", "val/mbo"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())


def test_dvae_trainer_anneals_tau_and_matches_jax():
    """The dVAE's trainer: `gumbel_tau` from `init_tau` by the JAX cosine
    over `tau_decay_pct` of the run's steps, passed to `compute_losses`
    as `sched`; the step's loss and grad norm against the JAX loss at
    that temperature with the gumbel sample shared, rtol 1e-5."""
    cfg, jm, jv, tm = build_pair(cfg=tiny_baseline_config("dVAE"))
    model, trainer = _trainer(cfg, tm, max_epochs=10, tau_decay_pct=0.5)
    steps = 10 * len(trainer.data)
    for step in (0, 3, steps // 2, steps):
        want = float(jblocks.cosine_anneal(jnp.int32(step), 1.0, 0.1, 0,
                                           0.5 * steps))
        np.testing.assert_allclose(
            trainer.step_scalars["gumbel_tau"](step), want, rtol=1e-6)
    trainer.step = 3
    tau = trainer.sched_kwargs()["sched"]["gumbel_tau"]
    assert 0.1 < tau < 1.0
    x = video(2, B=B, T=1)
    key = jax.random.PRNGKey(2)
    e = np.array(jax.random.exponential(key, (B, 1, H4, H4, VOCAB)))
    compute = model.compute_losses
    seen = {}

    def with_sample(batch, gen, sched):
        seen.update(sched)
        return compute(batch, gen, sched=sched,
                       exp_sample=torch.from_numpy(e))

    model.compute_losses = with_sample
    m = trainer.train_step({"img": torch.from_numpy(x)})
    model.compute_losses = compute
    assert seen == {"gumbel_tau": tau}

    def jloss(m, img):
        z = jblocks.gumbel_softmax(key, jax.nn.log_softmax(
            m.encode_logits(img), -1), tau=tau)
        return jnp.mean((m.detokenize(z) - img) ** 2)

    value, grads = _value_and_grad(jm, jloss)(jv["params"], x)
    np.testing.assert_allclose(m["train/recon_loss"], float(value),
                               rtol=1e-5)
    np.testing.assert_allclose(m["train/grad_norm"],
                               float(optax.global_norm(grads)), rtol=1e-5)
    res = trainer.validate()
    assert set(res) == {"val/recon_loss"} and np.isfinite(
        res["val/recon_loss"])


# ---- init_reference_ ------------------------------------------------------

# as tests/test_torch_image_training.py: 16 inits a side, each leaf's std
# pooled over them, +-25 %
DRAWS, STD_BAND = 16, 0.25


def test_reference_init_matches_flax_for_the_baselines():
    """STEVE with the LSTM predictor (the encode side, the LSTM, the dVAE
    and the AR decoder): the same leaves; biases 0 and norm scales 1 on
    both sides; every other leaf's std, pooled over 16 inits, within 25 %
    of flax's: the AR projections' `variance_scaling` over fan_avg (the
    output ones at gain^2), the FFN's kaiming truncated normal,
    `tok_emb`'s N(0, 0.02^2), `pos_emb`'s normal cut at +-2, the LSTM's
    orthogonal recurrent blocks and lecun-normal input weights, the
    dVAE's lecun-normal convs."""
    cfg = tiny_baseline_config("STEVE", pred_dict=dict(
        pred_type="transformer", pred_rnn=True, pred_num_layers=1,
        pred_num_heads=2, pred_ffn_dim=2 * SLOT_SIZE))
    jm = build_jax_model(jax_params_of(cfg))
    x = jnp.asarray(video())
    init = jax.jit(lambda key: jm.init({"params": key}, {"img": x})[
        "params"])
    jstates = [convert_model(jax.tree_util.tree_map(np.asarray, init(key)),
                             cfg)
               for key in jax.random.split(jax.random.PRNGKey(0), DRAWS)]
    model = build_model(cfg, device="cpu")
    pstates = []
    for seed in range(DRAWS):
        init_reference_(model, torch.Generator().manual_seed(seed))
        pstates.append({n: p.detach().clone()
                        for n, p in model.named_parameters()})
    assert set(jstates[0]) == set(pstates[0])
    bad, checked = [], 0
    for n, v in pstates[0].items():
        j = torch.stack([s[n] for s in jstates]).double()
        p = torch.stack([s[n] for s in pstates]).double()
        if v.dim() == 1:  # norm scales are "weight", the rest biases
            one = float(n.endswith("weight"))
            assert (j == one).all() and (p == one).all(), n
        elif "init_latents" not in n:
            ratio = (p.std() / j.std()).item()
            checked += 1
            if not abs(ratio - 1) <= STD_BAND:
                bad.append((n, ratio))
            assert abs(p.mean().item()) <= 0.25 * j.std().item(), n
    assert checked >= 40 and not bad, bad
    for key in ("trans_decoder.pos_emb.pe", "trans_decoder.tok_emb.weight",
                "savi.predictor.rnn.weight_hh_l0", "dvae.encoder.0.m.weight",
                "trans_decoder.tf_dec.blocks.1.ffn.0.weight"):
        assert key in pstates[0]
