"""The port's training path against the JAX package, on the CPU.

A tiny SAViDiffusion of the flagship's structure (tests/
torch_parity_helpers.py) holds the same seeded weights on both sides. The
same clips, timesteps and noise (numpy, fixed seeds) go through the JAX
model under `jax.grad` and through the port's `compute_losses` +
backward; the optimizer chain is held against optax, the EMA against the
JAX package's, and the trainer is run, repeated and resumed.

The JAX model off the TPU runs slot attention in f32 (`use_pallas` needs
a TPU), so the port's model here takes its f32 path too (`use_pallas=
False`); the bf16 kernel path's gradients are held against the f32 twin in
tests/test_torch_kernels.py. Dropout is 0 in the tiny config, and the JAX
side composes `q_sample` + `denoise(train=False)` itself, because
`make_rng` draws can never equal a torch.Generator's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.flatten_util import ravel_pytree
import torch
from torch import nn

from slotdiffusion_tpu.training.ema import \
    ExponentialMovingAverage as JaxEMA
from slotdiffusion_tpu.training.optim import build_optimizer
from slotdiffusion_tpu_torch.convert import convert_savi_diffusion
from slotdiffusion_tpu_torch.data.synthetic import (SyntheticVideoData,
                                                    SyntheticVideoDataset)
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.models import build_model, init_random_
from slotdiffusion_tpu_torch.training.checkpoint import (graft_pretrained,
                                                         load_checkpoint,
                                                         save_checkpoint)
from slotdiffusion_tpu_torch.training.ema import ExponentialMovingAverage
from slotdiffusion_tpu_torch.training.optim import (Optimizer,
                                                    cosine_warmup_schedule)
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, T_FRAMES,
                                  build_pair, t2n, tiny_config, video)

B = 2
LAT = (RES[0] // 4, RES[1] // 4, 3)


@pytest.fixture(scope="module")
def pair():
    return build_pair(use_pallas=False)


def _draws(seed=0):
    """Clips, timesteps and latent noise for B clips of T frames."""
    r = np.random.RandomState(seed)
    t = r.randint(0, 50, size=B * T_FRAMES)
    noise = r.randn(B * T_FRAMES, *LAT).astype(np.float32)
    return video(seed, B=B), t, noise


@pytest.fixture(scope="module")
def jax_value_and_grad(pair):
    """jit of (params, clips, t, noise) -> (denoise loss, gradients) of the
    tiny JAX model, composed as below."""
    cfg, jmodel, jvars, _ = pair

    def f(m, img, t, noise):
        out = m({"img": img}, train=True)
        flat = img.reshape(-1, *img.shape[2:])
        slots = out["slots"].reshape(-1, SLOTS, SLOT_SIZE)
        dm = m.dm_decoder
        x0 = dm.encode_latent(flat)
        pred = dm.denoise(dm.q_sample(x0, t, noise), t, context=slots,
                          train=False)
        return jnp.mean((pred - noise) ** 2)

    def loss(params, img, t, noise):
        return jmodel.apply({"params": params}, img, t, noise, method=f)

    vg = jax.jit(jax.value_and_grad(loss))
    return lambda params, img, t, noise: vg(
        params, jnp.asarray(img), jnp.asarray(t, jnp.int32),
        jnp.asarray(noise))


@pytest.fixture(scope="module")
def jax_loss_and_grads(pair, jax_value_and_grad):
    value, grads = jax_value_and_grad(pair[2]["params"], *_draws())
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def _torch_loss_and_grads(model):
    img, t, noise = _draws()
    model.train()
    model.dm_decoder.vae.requires_grad_(False)
    model.zero_grad(set_to_none=True)
    _, losses = model.compute_losses(
        {"img": torch.from_numpy(img)}, t=torch.from_numpy(t),
        noise=torch.from_numpy(noise))
    losses["denoise_loss"].backward()
    return losses["denoise_loss"].item(), {
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in model.named_parameters()}


def test_denoise_loss_and_every_gradient_match_jax(pair, jax_loss_and_grads):
    """f32 on both sides, the same formulas summed in another order
    through ~60 layers: rtol 1e-4, and atol 2e-5 of the leaf's largest
    gradient, or of a hundredth of the model's largest where that is
    larger (a leaf whose gradient is zero in exact arithmetic holds f32
    noise: the q-LN bias of slot attention, and the time-embedding
    projection into a GroupNorm of one channel per group). The largest
    error measured beyond rtol is 7.5e-6 of its leaf's scale (the
    cross-attention's to_v of the first level): an atol of 1e-6 would
    not hold f32 sums through the ResNet, slot attention and UNet."""
    cfg, _, _, tmodel = pair
    model = copy.deepcopy(tmodel)
    want_loss, jgrads = jax_loss_and_grads
    loss, grads = _torch_loss_and_grads(model)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    want = convert_savi_diffusion(jgrads, cfg)
    assert set(want) == set(grads)
    floor = 1e-2 * max(g.abs().max().item() for g in want.values())
    for name, w in want.items():
        g = grads[name]
        if name.startswith("dm_decoder.vae."):
            # the frozen VQ-VAE: encoded under stop_gradient / no_grad
            assert w.abs().max() == 0 and g.abs().max() == 0, name
            continue
        assert w.abs().max() > 0, name
        np.testing.assert_allclose(
            t2n(g), t2n(w), rtol=1e-4,
            atol=2e-5 * max(w.abs().max().item(), floor), err_msg=name)


# ---- the optimizer chain and the EMA against optax / the JAX package ----

def _named(seed=0):
    r = np.random.RandomState(seed)
    shapes = {"enc.w": (4, 3), "enc.b": (3,), "dm_decoder.w": (5, 2),
              "dm_decoder.b": (2,)}
    return {n: r.randn(*s).astype(np.float32) for n, s in shapes.items()}


def _nest(flat):
    out = {}
    for name, v in flat.items():
        a, b = name.split(".")
        out.setdefault(a, {})[b] = v
    return out


@pytest.mark.parametrize("clip,accum", [(0.5, 2), (None, 1), (50.0, 3)])
def test_optimizer_matches_optax(clip, accum):
    """Adam, the warmup-cosine schedule, the dm_decoder LR group,
    global-norm clipping and k-step accumulation: 5 updates against the
    JAX package's `build_optimizer` on the same gradients, to 1e-6."""
    init = _named(0)
    kw = dict(lr=1e-2, total_steps=5, warmup_steps=2, min_lr=1e-4,
              clip_grad=clip, grad_accum_steps=accum,
              lr_groups={"dm_decoder": 3e-2})
    tx, _ = build_optimizer(_nest(init), **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, _nest(init))
    state = tx.init(jparams)
    params = {n: nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt = Optimizer(list(params.items()), **kw)
    r = np.random.RandomState(1)
    for micro in range(5 * accum):
        scale = (0.05, 1.0, 3.0)[micro % 3]  # below and above the clip
        grads = {n: (r.randn(*v.shape) * scale).astype(np.float32)
                 for n, v in init.items()}
        upd, state = tx.update(jax.tree_util.tree_map(
            jnp.asarray, _nest(grads)), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n, p in params.items():
            g = torch.from_numpy(grads[n]) * opt.backward_scale()
            p.grad = g if p.grad is None else p.grad + g
        updated, _ = opt.step()
        assert updated == ((micro + 1) % accum == 0)
        for n, p in params.items():
            a, b = n.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[a][b]),
                                       rtol=1e-6, atol=1e-6, err_msg=n)


def test_schedule_matches_jax():
    from slotdiffusion_tpu.training.optim import \
        cosine_warmup_schedule as jax_schedule
    for args in ((1e-4, 100, 5), (2e-4, 10, 0), (1.0, 7, 7)):
        mine, ref = cosine_warmup_schedule(*args), jax_schedule(*args)
        for step in range(-1, args[1] + 3):
            # the JAX schedule evaluates in f32
            np.testing.assert_allclose(mine(step), float(ref(step)),
                                       rtol=1e-6, atol=1e-6 * args[0])


class _TwoPart(nn.Module):
    def __init__(self):
        super().__init__()
        self.enc = nn.Linear(3, 2)
        self.dm_decoder = nn.Linear(2, 4)


def test_ema_matches_jax():
    """LitEma's warmup decay min(decay, (1+n)/(10+n)) over 6 updates; the
    shadow covers the dm_decoder subtree, the one the eval swap uses."""
    model = _TwoPart()
    tree = lambda: {a: {b: jnp.asarray(t2n(getattr(getattr(model, a), b)))
                        for b in ("weight", "bias")}
                    for a in ("enc", "dm_decoder")}
    jema = JaxEMA.create(tree(), decay=0.99)
    ema = ExponentialMovingAverage(model, decay=0.99)
    assert set(ema.shadow) == {"dm_decoder.weight", "dm_decoder.bias"}
    g = torch.Generator().manual_seed(0)
    for _ in range(6):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.randn(p.shape, generator=g))
        jema = jema.update(tree())
        ema.update(model)
    for name, s in ema.shadow.items():
        a, b = name.split(".")
        np.testing.assert_allclose(t2n(s), np.asarray(jema.shadow[a][b]),
                                   rtol=1e-6, atol=1e-6)
    live = {n: p.detach().clone() for n, p in model.named_parameters()}
    with ema.swapped(model):
        assert torch.equal(model.dm_decoder.weight,
                           ema.shadow["dm_decoder.weight"])
        assert torch.equal(model.enc.weight, live["enc.weight"])
    for n, p in model.named_parameters():
        assert torch.equal(p, live[n])


def test_whole_train_step_matches_jax(pair, jax_loss_and_grads):
    """(loss, gradients) then one optimizer update, on both sides: the
    config's clip 0.05, lr 1e-4 and the dm_decoder group at 2e-4, no
    warmup (optax's first update takes schedule(0), which warmup makes 0).
    Adam's first update is lr * g / (|g| + 1e-8), about +-lr wherever the
    gradient is resolved; where it is below 1e-3 of its leaf's largest,
    f32 noise decides its sign on each side, so there the update is only
    held to its bound, lr (so is a whole leaf whose gradient is noise,
    below a hundredth of the model's largest: see the gradient test)."""
    cfg, _, jvars, tmodel = pair
    kw = dict(lr=1e-4, total_steps=10, warmup_steps=0, clip_grad=0.05,
              lr_groups={"dm_decoder": 2e-4})
    _, jgrads = jax_loss_and_grads
    # optax's chain is elementwise but for the global norm, so it runs on
    # each top-level subtree raveled into one vector (the same update,
    # without compiling one program per leaf)
    params, unravel = {}, {}
    for key, sub in jvars["params"].items():
        params[key], unravel[key] = ravel_pytree(sub)
    grads = {key: ravel_pytree(sub)[0] for key, sub in jgrads.items()}
    tx, _ = build_optimizer(params, **kw)
    upd, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    after = convert_savi_diffusion(
        {key: jax.tree_util.tree_map(np.asarray, unravel[key](v))
         for key, v in new.items()}, cfg)
    want_g = convert_savi_diffusion(jgrads, cfg)
    floor = 1e-2 * max(g.abs().max().item() for g in want_g.values())

    model = copy.deepcopy(tmodel)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _torch_loss_and_grads(model)
    opt = Optimizer(model.named_parameters(), **kw)
    updated, _ = opt.step()
    assert updated
    for name, p in model.named_parameters():
        lr = 2e-4 if name.startswith("dm_decoder") else 1e-4
        delta, want = p.detach() - before[name], after[name] - before[name]
        if name.startswith("dm_decoder.vae."):
            assert not p.requires_grad and delta.abs().max() == 0
            continue
        g = want_g[name].abs()
        resolved = g >= 1e-3 * max(g.max().item(), floor)
        # each side rounds p + update to p's f32 grid: 2^-22 of |p|
        ulp = 2.0 ** -22 * before[name].abs()
        err = (delta - want).abs()
        assert (err <= 1e-3 * want.abs() + 1e-3 * lr + ulp)[resolved].all(), \
            (name, err.max().item())
        assert (delta.abs() <= lr * (1 + 1e-5) + ulp).all(), name
        torch.testing.assert_close(p.detach(), after[name], rtol=1e-6,
                                   atol=2 * lr)


# ---- the trainer on the CPU ----------------------------------------------

def _trainer(tmp_path, seed=0, ckp="ck", **overrides):
    cfg = tiny_config(use_pallas=True).copy(
        max_epochs=2, print_iter=1, save_interval=0.5, use_ema=True,
        seed=seed, **overrides)
    cfg.dec_dict["unet_dict"]["dropout"] = 0.1  # dropout from the generator
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    data = SyntheticVideoData(cfg, batch_size=2, num_samples=6, seed=seed)
    return build_method(model, data, cfg, ckp_path=str(tmp_path / ckp))


def _run(trainer, steps):
    out = []
    while trainer.step < steps:
        out.append(trainer.fit(max_steps=trainer.step + 1))
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_grad_norm_matches_jax_every_micro_step(pair,
                                                        jax_value_and_grad,
                                                        accum):
    """`train/grad_norm` is logged on every micro-step and is the global
    norm of that micro-step's own unscaled gradient, as the JAX trainer
    logs `optax.global_norm(grads)` (training/trainer.py:289-290, 310):
    the trainer's steps on two micro-batches (fixed timesteps and noise,
    dropout 0) against `optax.global_norm` of `jax.grad` of the tiny JAX
    model on the same micro-batches, rtol 1e-5. At accum = 2 both
    micro-steps see the initial parameters (the update comes after the
    second); at accum = 1 the first step is compared."""
    cfg, _, jvars, tmodel = pair
    cfg = cfg.copy(grad_accum_steps=accum, print_iter=1)
    model = copy.deepcopy(tmodel)
    trainer = build_method(model, SyntheticVideoData(cfg, batch_size=B,
                                                     num_samples=2 * B),
                           cfg)
    compute = model.compute_losses
    draws = [_draws(seed) for seed in (0, 1)]
    got = []
    for img, t, noise in draws[:accum if accum > 1 else 1]:
        model.compute_losses = lambda batch, gen, t=t, noise=noise: compute(
            batch, t=torch.from_numpy(t), noise=torch.from_numpy(noise))
        got.append(trainer.train_step({"img": torch.from_numpy(img)}))
    for m, (img, t, noise) in zip(got, draws):
        _, grads = jax_value_and_grad(jvars["params"], img, t, noise)
        np.testing.assert_allclose(m["train/grad_norm"],
                                   float(optax.global_norm(grads)),
                                   rtol=1e-5)
    assert ("lr" in got[-1]) and ("lr" in got[0]) == (accum == 1)


def test_trainer_steps_repeat_and_resume_bit_exactly(tmp_path):
    """3 steps (across an epoch boundary: 3 batches an epoch) with dropout,
    EMA and 2-step accumulation: finite losses, parameters that move, the
    same losses from the same seed and other losses from another; a run
    cut after 2 steps and resumed from its ckpt_last ends bit-equal to
    the run that was not cut."""
    a = _trainer(tmp_path, ckp="a", grad_accum_steps=2)
    start = {n: p.detach().clone() for n, p in a.model.named_parameters()}
    ma = _run(a, 4)
    losses = [m["train/denoise_loss"] for m in ma]
    # every micro-step logs its gradient's norm; the update (and its lr)
    # comes on the second of each pair
    assert all(np.isfinite(losses))
    assert all(np.isfinite(m["train/grad_norm"]) for m in ma)
    assert "lr" not in ma[0] and "lr" in ma[1]
    moved = [n for n, p in a.model.named_parameters()
             if not torch.equal(p, start[n])]
    frozen = [n for n, _ in a.model.named_parameters()
              if n.startswith("dm_decoder.vae.")]
    assert set(moved) == set(start) - set(frozen)
    b = _trainer(tmp_path, ckp="b", grad_accum_steps=2)
    assert [m["train/denoise_loss"] for m in _run(b, 4)] == losses
    c = _trainer(tmp_path, ckp="c", seed=1, grad_accum_steps=2)
    assert [m["train/denoise_loss"] for m in _run(c, 4)] != losses

    d = _trainer(tmp_path, ckp="d", grad_accum_steps=2)
    _run(d, 3)  # stops mid-accumulation, in the second epoch
    ckpt = tmp_path / "d" / "ckpt_last.pt"
    e = _trainer(tmp_path, ckp="e", grad_accum_steps=2)
    last = e.fit(max_steps=4, resume_from=str(ckpt))
    assert e.step == 4 and last["train/denoise_loss"] == losses[-1]
    for (n, p), q in zip(a.model.named_parameters(), e.model.parameters()):
        assert torch.equal(p, q), n
    for n, s in a.ema.shadow.items():
        assert torch.equal(s, e.ema.shadow[n]), n
    assert (tmp_path / "a" / "train_log.jsonl").read_text().count("\n") == 4


def test_checkpoint_is_replaced_whole_and_grafts_a_vae(tmp_path):
    path = tmp_path / "ckpt_last.pt"
    save_checkpoint(str(path), {"step": 1})
    save_checkpoint(str(path), {"step": 2, "w": torch.ones(2)})
    assert load_checkpoint(str(path))["step"] == 2
    assert [f.name for f in tmp_path.iterdir()] == ["ckpt_last.pt"]

    cfg = tiny_config()
    src = build_model(cfg, device="cpu")
    init_random_(src, torch.Generator().manual_seed(1))
    vae_file = tmp_path / "vqvae.pt"
    torch.save({"model": src.dm_decoder.vae.vqvae.state_dict()}, vae_file)
    dst = build_model(cfg, device="cpu")
    assert not graft_pretrained(dst, cfg)  # no path configured
    cfg.dec_dict["vae_dict"]["vqvae_ckp_path"] = str(vae_file)
    assert graft_pretrained(dst, cfg)
    for k, v in src.dm_decoder.vae.vqvae.state_dict().items():
        assert torch.equal(dst.dm_decoder.vae.vqvae.state_dict()[k], v)
    torch.save({"encoder.conv_in.weight": torch.zeros(1)}, vae_file)
    with pytest.raises(KeyError):
        graft_pretrained(dst, cfg)


def test_synthetic_clips_match_the_jax_dataset():
    from slotdiffusion_tpu.data.synthetic import \
        SyntheticVideoDataset as JaxClips
    kw = dict(resolution=(32, 32), num_samples=4, n_sample_frames=3,
              seed=2)
    for i in range(4):
        mine, ref = SyntheticVideoDataset(**kw)[i], JaxClips(**kw)[i]
        assert set(mine) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(mine[k], ref[k])


@pytest.mark.parametrize("target", ["eps", "v", "x0"])
def test_loss_targets_follow_the_jax_schedule(pair, target):
    """q_sample and the eps / v / x0 targets of `CondDDPM.loss_function`
    against the JAX package's schedule tables (`make_gaussian_schedule`)
    and its target formulas (models/diffusion.py:191-211)."""
    from slotdiffusion_tpu.models.schedules import make_gaussian_schedule
    from slotdiffusion_tpu_torch.models.diffusion import CondDDPM
    cfg, _, _, tmodel = pair
    d = cfg.dec_dict["diffusion_dict"]
    s = make_gaussian_schedule(d["beta_schedule"], d["timesteps"],
                               d["linear_start"], d["linear_end"])
    r = np.random.RandomState(3)
    x0, noise = (r.randn(4, *LAT).astype(np.float32) for _ in range(2))
    ctx = r.randn(4, SLOTS, SLOT_SIZE).astype(np.float32)
    t = np.array([0, 7, 23, d["timesteps"] - 1])
    a = s.sqrt_alphas_bar[t][:, None, None, None]
    sg = s.sqrt_one_minus_alphas_bar[t][:, None, None, None]
    gt = {"eps": noise, "v": a * noise - sg * x0, "x0": x0}[target]
    dm = copy.deepcopy(tmodel.dm_decoder).eval()
    dm.pred_target = target
    tt = {k: torch.from_numpy(v) for k, v in
          (("x0", x0), ("noise", noise), ("ctx", ctx), ("t", t))}
    with torch.no_grad():
        xt = dm.q_sample(tt["x0"], tt["t"], tt["noise"])
        np.testing.assert_allclose(t2n(xt), a * x0 + sg * noise, rtol=1e-6,
                                   atol=1e-6)
        pred = t2n(dm.denoise(xt, tt["t"], tt["ctx"]))
        loss = CondDDPM.loss_function(dm, tt["x0"], tt["ctx"], t=tt["t"],
                                      noise=tt["noise"])["denoise_loss"]
    np.testing.assert_allclose(loss.item(), np.mean((pred - gt) ** 2),
                               rtol=1e-5)
