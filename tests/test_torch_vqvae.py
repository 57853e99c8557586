"""The port's stage-1 VQ-VAE against the JAX package's, on the CPU.

A tiny VQ-VAE (16x16 images, ch 8, ch_mult (1, 2), 32 codes of 3) in three
layouts, the flagship's (mid attention only), one with attention at every
level (`attn_resolutions`) and one with none (`attn_type="none"`), holds
the same seeded weights on both sides (`slotdiffusion_tpu_torch.convert.
convert_vqvae`). The same numpy inputs, images and videos (T folded into
the batch), go through the API, the losses (L1, the commitment loss with
`beta`, LPIPS on a seeded `.npz`) and `jax.grad` of the weighted total;
then one trainer step against optax, LPIPS alone, the repo's two trained
VQ-VAE checkpoints, bf16, dropout, the reference init, the synthetic and
MOVi data of the VQ-VAE configs, and the handoff of a stage-1
`ckpt_last.pt` to SAViDiffusion.

The JAX side runs at "highest" matmul precision (tests/conftest.py).
Dropout masks come from a torch.Generator on one side and `make_rng` on
the other, so the parity cases run at rate 0 and dropout is held alone.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slotdiffusion_tpu.data import build_dataset as jax_build_dataset
from slotdiffusion_tpu.data.loader import DataLoader as JaxLoader
from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.models.vqvae import VQVAE as JaxVQVAE
from slotdiffusion_tpu.ops import lpips as jax_lpips
from slotdiffusion_tpu.training.checkpoint import load_model_params
from slotdiffusion_tpu.training.optim import build_optimizer
from slotdiffusion_tpu.utils import BaseParams, load_params
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import (convert_vqvae,
                                             convert_vqvae_state_dict)
from slotdiffusion_tpu_torch.data import build_dataset
from slotdiffusion_tpu_torch.data.loader import DataModule
from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.models import build_model, init_reference_
from slotdiffusion_tpu_torch.models.vqvae import (VQVAE, ResnetBlock,
                                                  VQVAEWrapper)
from slotdiffusion_tpu_torch.ops import lpips
from slotdiffusion_tpu_torch.training.checkpoint import (graft_pretrained,
                                                         load_model_weights)
from torch_parity_helpers import (ROUNDS, WHOLE_C, random_params, t2n,
                                  tiny_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16
ED = dict(resolution=RES, in_channels=3, z_channels=3, ch=8, ch_mult=[1, 2],
          num_res_blocks=1, attn_resolutions=[], out_ch=3, dropout=0.0)
VQ = dict(n_embed=32, embed_dim=3, beta=0.25, percept_loss_w=1.0)
LAYOUTS = {"flagship": {}, "attn": dict(attn_resolutions=[16, 8]),
           "no_attn": dict(attn_type="none")}
# f32 on both sides, the same formulas summed in another order: outputs
# to 1e-5 of their scale (measured: <= 2e-6)
OUT_RTOL = 1e-5
# an index may differ only where the JAX side's best and second-best
# scores are closer than this (f32 rounding of scores of magnitude ~1)
TIE = 1e-4
TRAINED = {
    "params": ("configs/vqvae_synthetic_params-res64.py",
               "checkpoint/vqvae_synthetic_params-res64/ckpt_last",
               "VQVAESynthetic64"),
    "lpips": ("configs/vqvae_synthetic_lpips-res64.py",
              "checkpoint/vqvae_synthetic_lpips-res64/ckpt_final",
              "VQVAESyntheticLPIPS64"),
}
# index agreement on trained weights (the acceptance bar)
TRAINED_AGREEMENT = 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: small ops gain nothing from more, and beside
    other test processes more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """The seed-0 random LPIPS npz (the JAX package's writer), named by
    SLOTDIFFUSION_LPIPS_WEIGHTS for both packages while this file runs."""
    path = str(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    jax_lpips.save_random_lpips_npz(path, seed=0)
    old = os.environ.get(lpips.WEIGHTS_ENV)
    os.environ[lpips.WEIGHTS_ENV] = path
    jax_lpips._load_weights.cache_clear()
    # load outside any jit: its cache would otherwise keep the arrays of
    # the first trace, which leak out of it
    jax_lpips._load_weights()
    yield path
    if old is None:
        del os.environ[lpips.WEIGHTS_ENV]
    else:
        os.environ[lpips.WEIGHTS_ENV] = old
    jax_lpips._load_weights.cache_clear()


def _ed(layout):
    return dict(ED, **LAYOUTS[layout])


_PAIRS = {}


def pair(layout, dtype=jnp.float32):
    """-> (JAX VQVAE, its params, port VQVAE on the CPU) on one seeded
    set of f32 weights (codebook entries U(-1, 1))."""
    key = (layout, dtype)
    if key not in _PAIRS:
        ed = _ed(layout)
        jm = JaxVQVAE(ed, VQ, dtype=dtype)
        shapes = jax.eval_shape(lambda r, x: jm.init(r, {"img": x}),
                                {"params": jax.random.PRNGKey(0)},
                                jnp.zeros((1, RES, RES, 3)))
        params = random_params(shapes["params"], seed=0)
        tm = VQVAE(ed, VQ, torch.bfloat16 if dtype == jnp.bfloat16
                   else torch.float32)
        tm.load_state_dict(convert_vqvae_state_dict(params, ed),
                           strict=True)
        _PAIRS[key] = (jm, jax.tree_util.tree_map(jnp.asarray, params), tm)
    return _PAIRS[key]


def images(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (*shape, RES, RES, 3)
                                               ).astype(np.float32)


def _jax_api(m, x):
    h = m.encode(x)
    z_q, loss, idx = m.encode_quantize(x)
    flat = h.reshape(-1, h.shape[-1])
    e = m.quantize.embedding
    scores = 2.0 * flat @ e.T - jnp.sum(e ** 2, -1)[None]
    top2 = jax.lax.top_k(scores, 2)[0]
    return dict(encode=h, z_q=z_q, quant_loss=loss, idx=idx,
                decode=m.decode(z_q), quantize_decode=m.quantize_decode(h),
                gap=(top2[:, 0] - top2[:, 1]).reshape(idx.shape),
                recon=m({"img": x})["recon"])


@pytest.mark.parametrize("shape", [(2,), (2, 3)], ids=["image", "video"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_api_matches_jax(layout, shape):
    """encode, encode_quantize (z_q, the loss, the indices: equal away
    from near-ties, TIE), decode, quantize_decode and forward's recon, on
    images [B, H, W, 3] and videos [B, T, H, W, 3], to OUT_RTOL of each
    output's scale."""
    jm, params, tm = pair(layout)
    x = images(shape)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=_jax_api))(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        h = tm.encode(xt)
        z_q, loss, idx = tm.encode_quantize(xt)
        got = dict(encode=h, z_q=z_q, quant_loss=loss, decode=tm.decode(z_q),
                   quantize_decode=tm.quantize_decode(h),
                   recon=tm({"img": xt})["recon"])
    away = np.asarray(want["gap"]) > TIE
    assert away.mean() > 0.9
    np.testing.assert_array_equal(t2n(idx)[away], np.asarray(want["idx"])[away])
    assert idx.shape == want["idx"].shape == (*shape, RES // 2, RES // 2)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert tuple(v.shape) == w.shape, k
        np.testing.assert_allclose(t2n(v), w, rtol=OUT_RTOL,
                                   atol=OUT_RTOL * np.abs(w).max(),
                                   err_msg=k)
    # z_q is the straight-through z + (z_q - z): the entry to f32 rounding
    torch.testing.assert_close(tm.quantize.codebook_entry(idx), z_q,
                               rtol=0, atol=1e-6)


def _jax_total(jm, layout):
    def total(p, x):
        _, losses = jm.apply({"params": p}, {"img": x}, train=True,
                             method=jm.compute_losses)
        return sum(losses.values()), losses
    return jax.jit(jax.value_and_grad(total, has_aux=True))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_losses_and_every_gradient_match_jax(layout, lpips_npz):
    """compute_losses on a video batch (L1 recon, the commitment loss with
    beta 0.25, LPIPS on the seed-0 npz) to 1e-5 relative, and the gradient
    of their sum (the config's unit weights) for every parameter against
    jax.grad: rtol 1e-4 and atol 1e-5 of the leaf's largest gradient; a
    leaf whose gradient is zero in exact arithmetic (below 1e-4 of the
    model's largest on the JAX side) is held below that on both. This
    holds the
    straight-through estimator (the encoder's gradient passes the
    quantizer) and beta's placement (the codebook's gradient is beta's
    term alone)."""
    jm, params, tm = pair(layout)
    x = images((2, 2), seed=1)
    (_, jlosses), jgrads = _jax_total(jm, layout)(params, jnp.asarray(x))
    tm.zero_grad(set_to_none=True)
    _, losses = tm.compute_losses({"img": torch.from_numpy(x)},
                                  torch.Generator().manual_seed(0))
    assert set(losses) == set(jlosses) == {"recon_loss", "quant_loss",
                                           "percept_loss"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jlosses[k]), rtol=1e-5,
                                   err_msg=k)
    sum(losses.values()).backward()
    want = convert_vqvae(jax.tree_util.tree_map(np.asarray, jgrads),
                         _ed(layout))
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(want) == set(grads)
    noise = 1e-4 * max(np.abs(w).max() for w in want.values())
    compared = set()
    for n, w in want.items():
        g = t2n(grads[n])
        if np.abs(w).max() < noise:
            # zero in exact arithmetic: a bias whose channel reaches only
            # GroupNorms of one channel per group (the width is 8 and 16
            # here), which remove it; both sides hold f32 noise there
            assert w.ndim == 1 and np.abs(g).max() < noise, n
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)
        compared.add(n)
    assert len(compared) >= len(want) // 2
    assert {"quantize.embedding.weight", "encoder.conv_in.weight",
            "quant_conv.weight"} <= compared


def test_trainer_step_matches_optax():
    """One Trainer step of the port's VQ-VAE method (build_method, Adam at
    lr 1e-3, no clipping; warmup 0, since optax's first update takes
    schedule(0), which warmup makes 0) against the JAX gradient and one
    optax update from build_optimizer. Adam's first update is
    lr * g / (|g| + eps), +-lr wherever the gradient is resolved: there
    the update agrees to 1e-3 of itself; where the gradient is below 1e-3
    of its leaf's largest, or of a hundredth of the model's largest where
    that is larger (a leaf whose gradient is zero in exact arithmetic:
    see the gradient test), f32 noise decides its sign, and only the
    bound lr is held."""
    _, params, tm0 = pair("flagship")
    vq = dict(VQ, percept_loss_w=0.0)  # L1 + quant, as VQVAESynthetic64
    jm = JaxVQVAE(ED, vq)
    cfg = configs.VQVAESynthetic64().copy(
        resolution=(RES, RES), enc_dec_dict=ED, vq_dict=vq,
        warmup_steps_pct=0.0, train_batch_size=2, val_batch_size=2)
    x = images((2, 1), seed=2)
    (_, _), jgrads = _jax_total(jm, "flagship")(params, jnp.asarray(x))
    kw = dict(lr=cfg.lr, total_steps=10, warmup_steps=0, clip_grad=-1.0)
    tx, _ = build_optimizer(params, **kw)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    after = convert_vqvae(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, upd)), ED)
    want_g = convert_vqvae(jax.tree_util.tree_map(np.asarray, jgrads), ED)

    model = build_model(cfg, device="cpu")
    model.load_state_dict(tm0.state_dict())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = build_method(model, SyntheticVideoData(cfg, 2, num_samples=2),
                           cfg)
    model.train()
    m = trainer.train_step({"img": torch.from_numpy(x)})
    assert "lr" in m and set(m) >= {"train/recon_loss", "train/quant_loss"}
    lr = cfg.lr
    floor = 1e-2 * max(np.abs(g).max() for g in want_g.values())
    for n, p in model.named_parameters():
        delta = p.detach() - before[n]
        w = torch.from_numpy(after[n].copy()) - before[n]
        g = np.abs(want_g[n])
        resolved = torch.from_numpy(g >= 1e-3 * max(g.max(), floor))
        ulp = 2.0 ** -22 * before[n].abs()
        err = (delta - w).abs()
        assert (err <= 1e-3 * w.abs() + 1e-3 * lr + ulp)[resolved].all(), n
        assert (delta.abs() <= lr * (1 + 1e-5) + ulp).all(), n


def test_lpips_matches_jax(lpips_npz, tmp_path):
    """The port's save_random_lpips_npz writes the JAX function's arrays
    bit for bit; lpips_distance on the same images (and with the same
    weights stored HWIO) agrees with the JAX one to 1e-5 relative; the net
    has no parameters, and a gradient reaches the input."""
    mine = str(tmp_path / "mine.npz")
    lpips.save_random_lpips_npz(mine, seed=0)
    with np.load(mine) as a, np.load(lpips_npz) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        hwio = {k: (v.transpose(2, 3, 1, 0) if k.endswith("_w") and
                    v.ndim == 4 else v) for k, v in ((k, b[k])
                                                     for k in b.files)}
    hwio_path = str(tmp_path / "hwio.npz")
    np.savez(hwio_path, **hwio)
    r = np.random.RandomState(3)
    x, y = (r.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax_lpips.lpips_distance(jnp.asarray(x),
                                               jnp.asarray(y)))
    xt = torch.from_numpy(x).requires_grad_(True)
    for path in (None, mine, hwio_path):
        got = lpips.lpips_distance(xt, torch.from_numpy(y), path)
        np.testing.assert_allclose(t2n(got), want, rtol=1e-5)
    assert lpips.lpips_available() and not lpips.lpips_available(
        str(tmp_path / "absent.npz"))
    assert not list(lpips.load_lpips(mine, "cpu").parameters())
    got.sum().backward()
    assert xt.grad.abs().max() > 0


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which", list(TRAINED))
def test_trained_checkpoint_matches_jax(which, lpips_npz, tmp_path):
    """The repo's trained VQ-VAE, exported by
    scripts/export_torch_checkpoint.py --vqvae and loaded strictly into
    the port's config of it: recon to 1e-4 of its scale, the losses
    (percept_loss live for the LPIPS run, on the seed-0 npz it trained
    on) to 1e-4 relative, and the token ids equal at >= 99.9 % of the
    positions, on 4 val frames of its own data."""
    jax_config, ckpt, name = TRAINED[which]
    pt = str(tmp_path / "vqvae.pt")
    state = _script("export_torch_checkpoint").export(
        os.path.join(REPO, jax_config), os.path.join(REPO, ckpt), pt,
        vqvae=True)
    assert state["config"] == name and not state["ema"]
    cfg = configs.get_config(name).copy(lpips_weights=lpips_npz)
    model = build_model(cfg, device="cpu")
    load_model_weights(model, pt)
    jparams = load_params(os.path.join(REPO, jax_config))
    jm = build_jax_model(jparams)
    jvars = load_model_params(jm, os.path.join(REPO, ckpt), jparams)
    val = build_dataset(cfg, val_only=True)
    x = np.stack([val[i]["img"] for i in range(4)])  # [4, 1, 64, 64, 3]
    jout, jlosses = jax.jit(lambda v, x: jm.apply(
        v, {"img": x}, train=False, method=jm.compute_losses))(
        jvars, jnp.asarray(x))
    with torch.no_grad():
        out, losses = model.compute_losses({"img": torch.from_numpy(x)},
                                           train=False)
    want = {"recon_loss", "quant_loss"} | (
        {"percept_loss"} if which == "lpips" else set())
    assert set(losses) == set(jlosses) == want
    for k in want:
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]),
                                   rtol=1e-4, err_msg=k)
    agree = (t2n(out["token_id"]) == np.asarray(jout["token_id"])).mean()
    assert agree >= TRAINED_AGREEMENT, agree
    w = np.asarray(jout["recon"])
    np.testing.assert_allclose(t2n(out["recon"]), w, rtol=1e-4,
                               atol=1e-4 * np.abs(w).max())


def _bf16_outputs(m, x, z):
    """The latents, the decode of given latents, and the losses."""
    h = m.encode(x)
    _, losses = m.compute_losses({"img": x}, train=False)
    return dict(encode=h, decode=m.decode(z), recon_loss=losses["recon_loss"],
                quant_loss=losses["quant_loss"])


def test_bf16_matches_jax_bf16():
    """`use_bf16`: the JAX VQ-VAE with dtype bf16 and the port's with
    compute_dtype bf16 on the same f32 weights, at the gates of
    tests/test_torch_bf16.py: each output's root-mean-square distance to
    the JAX bf16 one, d, within WHOLE_C of the bf16 floor |jax16 - jax32|,
    and the port's own rounding |port16 - port32| within ROUNDS of the
    floor (an f32 port, whose own is 0, fails that; the per-layer test
    below holds the control against the JAX bf16 layer). The decode is
    of one set of f32 latents, so no code choice differs between the four
    models; the losses are scalars, held to 0.05 of themselves (the floor
    of a mean is noise). The JAX side is compiled with
    xla_allow_excess_precision off, as there."""
    j16, params, p16 = pair("flagship", jnp.bfloat16)
    j32, _, p32 = pair("flagship")
    x = images((2,), seed=4)
    with torch.no_grad():
        z = p32.encode(torch.from_numpy(x)).numpy()

    def run_jax(m):
        return jax.jit(lambda p, x, z: m.apply(
            {"params": p}, x, z, method=_bf16_outputs)).lower(
            params, jnp.asarray(x), jnp.asarray(z)).compile(
            compiler_options={"xla_allow_excess_precision": False})(
            params, jnp.asarray(x), jnp.asarray(z))

    want16, want32 = run_jax(j16), run_jax(j32)
    with torch.no_grad():
        got16, got32 = (_bf16_outputs(m, torch.from_numpy(x),
                                      torch.from_numpy(z))
                        for m in (p16, p32))
    f = lambda v: np.asarray(v.float() if isinstance(v, torch.Tensor)
                             else jnp.asarray(v, jnp.float32))
    rms = lambda a, b: float(np.sqrt(np.mean((f(a) - f(b)) ** 2)))
    for k in ("encode", "decode"):
        floor = rms(want16[k], want32[k])
        d, own = rms(got16[k], want16[k]), rms(got16[k], got32[k])
        print(f"{k}: d/floor {d / floor:.3f}, own/floor {own / floor:.3f}")
        assert floor > 0 and d <= WHOLE_C * floor, k
        assert ROUNDS[0] * floor <= own <= ROUNDS[1] * floor, k
    for k in ("recon_loss", "quant_loss"):
        np.testing.assert_allclose(float(got16[k]), float(want16[k]),
                                   rtol=0.05, err_msg=k)
    assert all(p.dtype == torch.float32 for p in p16.parameters())
    assert got16["encode"].dtype == got16["decode"].dtype == torch.float32


# the per-layer gate of tests/test_torch_bf16.py: d <= LAYER_C * floor,
# and the control, the f32 port layer against the JAX bf16 one, fails it
LAYER_C = 0.1


@pytest.mark.parametrize("name", ["ResnetBlock", "AttnBlock"])
def test_layer_rounds_as_jax_bf16(name):
    """The VQ-VAE's ResnetBlock (16 -> 32 channels, with its 1x1
    shortcut) and AttnBlock (32 channels) in bf16 against the JAX layers
    in bf16, on a bf16 input (what the layer before gives them), at the
    per-layer gate LAYER_C with its control."""
    from slotdiffusion_tpu.models import vqvae as jv
    from slotdiffusion_tpu_torch import convert
    from slotdiffusion_tpu_torch.models import vqvae as pv
    jmake, pmake, walk, cin = {
        "ResnetBlock": (lambda d: jv.ResnetBlock(32, dtype=d),
                        lambda d: pv.ResnetBlock(16, 32, compute_dtype=d),
                        convert._vq_resblock, 16),
        "AttnBlock": (lambda d: jv.AttnBlock(dtype=d),
                      lambda d: pv.AttnBlock(32, d),
                      convert._vq_attnblock, 32)}[name]
    x16 = jnp.asarray(np.random.RandomState(6).uniform(
        -2, 2, (2, 8, 8, cin)).astype(np.float32), jnp.bfloat16)
    x32 = x16.astype(jnp.float32)
    shapes = jax.eval_shape(jmake(jnp.float32).init,
                            jax.random.PRNGKey(0), x32)
    params = random_params(shapes["params"], seed=0)
    sd = {}
    walk(sd, "m", params)
    outs = {}
    for tag, dt, jdt, x in (("16", torch.bfloat16, jnp.bfloat16, x16),
                            ("32", torch.float32, jnp.float32, x32)):
        jm = jmake(jdt)
        outs["jax" + tag] = jax.jit(jm.apply).lower(
            {"params": params}, x).compile(compiler_options={
                "xla_allow_excess_precision": False})({"params": params}, x)
        pm = pmake(dt)
        pm.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
        xt = torch.from_numpy(np.array(x32)).to(dt).permute(0, 3, 1, 2)
        with torch.no_grad():
            outs["port" + tag] = pm(xt).permute(0, 2, 3, 1).float().numpy()
    f = lambda v: np.asarray(jnp.asarray(v, jnp.float32))
    rms = lambda a, b: float(np.sqrt(np.mean((f(a) - f(b)) ** 2)))
    floor = rms(outs["jax16"], outs["jax32"])
    d = rms(outs["port16"], outs["jax16"])
    ctl = rms(outs["port32"], outs["jax16"])
    print(f"{name}: d/floor {d / floor:.4f}, ctl/floor {ctl / floor:.3f}")
    assert floor > 0 and d <= LAYER_C * floor
    assert ctl > LAYER_C * floor, "the control passes"


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_rate_scale_and_eval_identity(p):
    """The ResnetBlock's dropout, at the JAX position (after the second
    GN+SiLU, before the second conv): with train=True the share of dropped
    values over 131,072 is within 5 binomial standard deviations of p and
    every kept value is x / (1 - p); the same seed gives the same mask
    and another seed another; train=False is the identity and train=True
    needs a generator. The frozen wrapper never drops, whatever the
    module's mode."""
    blk = ResnetBlock(8, 8, dropout=p)
    seen = []
    blk.conv2.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -2, 2, (4, 8, 64, 64)).astype(np.float32))
    with torch.no_grad():
        blk(x)
        ref = seen.pop()
        y = blk(x, True, torch.Generator().manual_seed(0))
        drop = seen.pop()
    n = ref.numel()
    dropped = (drop == 0) & (ref != 0)
    assert abs(dropped.float().mean().item() - p) <= 5 * (p * (1 - p) / n
                                                         ) ** 0.5
    kept = drop != 0
    assert torch.equal(drop[kept], ref[kept] / (1 - p))
    with torch.no_grad():
        assert torch.equal(y, blk(x, True, torch.Generator().manual_seed(0)))
        assert not torch.equal(y, blk(x, True,
                                      torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError):
        blk(x, True)
    wrapper = VQVAEWrapper(dict(ED, dropout=p), VQ).train()
    img = torch.from_numpy(images((1,)))
    with torch.no_grad():
        assert torch.equal(wrapper.encode(img), wrapper.eval().encode(img))


def test_reference_init_matches_jax_init():
    """init_reference_ of a bare VQ-VAE against the JAX VQVAE's own
    `init` (flax's lecun_normal convs, zero biases, unit GN scales, the
    codebook U(-1/n, 1/n)), leaf by leaf over 16 draws: zeros and ones
    exact, each leaf's std within 25 % of the JAX one (the smallest leaf,
    the 3 -> 3 quant convs of 9 values, pooled over 16 draws: about three
    standard errors of the difference), codebooks within +-1/n."""
    draws = 16
    jm = JaxVQVAE(ED, VQ)
    x = jnp.zeros((1, RES, RES, 3))
    batched = jax.jit(jax.vmap(lambda k: jm.init(
        {"params": k}, {"img": x})["params"]))(
        jax.random.split(jax.random.PRNGKey(0), draws))
    jstates = [convert_vqvae(jax.tree_util.tree_map(
        lambda a: np.asarray(a[i]), batched), ED) for i in range(draws)]
    cfg = configs.VQVAESynthetic64().copy(enc_dec_dict=ED, vq_dict=VQ)
    model = build_model(cfg, device="cpu")
    pstates = []
    for seed in range(draws):
        init_reference_(model, torch.Generator().manual_seed(seed))
        pstates.append({n: t2n(p).copy() for n, p in
                        model.named_parameters()})
    assert set(jstates[0]) == set(pstates[0])
    for n in jstates[0]:
        j = np.stack([s[n] for s in jstates])
        q = np.stack([s[n] for s in pstates])
        assert j.shape == q.shape, n
        if n.endswith("bias"):
            assert not j.any() and not q.any(), n
        elif (j == 1).all():
            assert (q == 1).all(), n
        else:
            assert abs(q.std() / j.std() - 1) <= 0.25, n
            assert abs(q.mean()) <= 3 * q.std() / np.sqrt(q.size), n
        if n == "quantize.embedding.weight":
            bound = 1.0 / VQ["n_embed"]
            assert np.abs(j).max() <= bound and np.abs(q).max() <= bound


@pytest.mark.parametrize("jax_config", [
    "configs/vqvae_synthetic_params-res64.py",
    "configs/savi_ldm_synthetic_params-res64.py"])
def test_synthetic_splits_follow_the_config(jax_config):
    """build_dataset("synthetic_video") reads train_samples, val_samples,
    max_objects and load_mask as the JAX builder does: the same split
    lengths, masks or none, the first batch of 4 bit for bit (object
    counts follow from max_objects)."""
    p = load_params(os.path.join(REPO, jax_config))
    jtrain, jval = jax_build_dataset(p)
    train, val = build_dataset(p)
    assert (len(train), len(val)) == (len(jtrain), len(jval)) == (128, 16)
    assert train.max_objects == jtrain.max_objects == p.max_objects
    for mine, theirs in ((train, jtrain), (val, jval)):
        for i in range(4):
            a, b = mine[i], theirs[i]
            assert set(a) == set(b) and ("masks" in a) == p.load_mask
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_movi_frames_of_the_vqvae_config_are_the_jax_loaders(tmp_path):
    """VQVAEMoviE128's MOVi data (single frames, no masks, video_len 24)
    on a generated tree of 2 train and 2 val videos of 24 frames: the
    JAX loader's batches bit for bit, in order, for two epochs of the
    shuffled train split and the val split."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from gen_movi_tree import write_split
    from slotdiffusion_tpu.data.movi import build_movi_dataset
    root = str(tmp_path)
    write_split(root, "E", "train", 2, 24, 16, 0)
    write_split(root, "E", "validation", 2, 24, 16, 1)
    old = os.environ.get("SLOTDIFFUSION_CACHE")
    os.environ["SLOTDIFFUSION_CACHE"] = str(tmp_path / "cache")
    try:
        cfg = configs.VQVAEMoviE128().copy(data_root=root,
                                           resolution=(16, 16))
        p = BaseParams()
        for k in ("dataset", "movi_level", "data_root", "resolution",
                  "n_sample_frames", "frame_offset", "video_len",
                  "load_mask"):
            setattr(p, k, getattr(cfg, k))
        jtrain, jval = build_movi_dataset(p)
        train, val = build_dataset(cfg)
        assert (len(train), len(val)) == (len(jtrain), len(jval)) == (48, 48)
        assert train[0]["img"].shape == (1, 16, 16, 3)
        assert "masks" not in train[0] and "masks" not in val[0]
        dm = DataModule(train, val, 8, seed=3)
        loaders = [(JaxLoader(jval, batch_size=8, shuffle=False,
                              drop_last=False, num_workers=1),
                    dm.val_loader())]
        for epoch in (0, 1):
            jl = JaxLoader(jtrain, batch_size=8, shuffle=True,
                           drop_last=True, num_workers=1, seed=3)
            jl.set_epoch(epoch)
            loaders.append((jl, dm.train_loader(epoch)))
        for jl, tl in loaders:
            n = 0
            for a, b in zip(jl, tl, strict=True):
                assert set(a) == set(b)
                for k in a:
                    assert np.array_equal(a[k], b[k].numpy()), k
                n += 1
            assert n == 6
    finally:
        if old is None:
            del os.environ["SLOTDIFFUSION_CACHE"]
        else:
            os.environ["SLOTDIFFUSION_CACHE"] = old


def test_stage1_checkpoint_grafts_into_savi_diffusion(tmp_path):
    """A port VQ-VAE trained one step by its Trainer writes ckpt_last.pt;
    a SAViDiffusion config naming that file as vqvae_ckp_path grafts it
    with no conversion: its dm_decoder.vae.vqvae holds the same tensors
    bit for bit and decodes a latent bit-identically to the stage-1
    model."""
    scfg = tiny_config()
    vae = scfg.dec_dict["vae_dict"]
    cfg = configs.VQVAESynthetic64().copy(
        resolution=scfg.resolution, enc_dec_dict=vae["enc_dec_dict"],
        vq_dict=vae["vq_dict"], train_batch_size=2, max_epochs=1)
    stage1 = build_model(cfg, device="cpu")
    init_reference_(stage1, torch.Generator().manual_seed(0))
    data = SyntheticVideoData(cfg, 2, num_samples=2, val_samples=2)
    trainer = build_method(stage1, data, cfg, ckp_path=str(tmp_path))
    trainer.fit(max_steps=1)
    ckpt = tmp_path / "ckpt_last.pt"
    assert ckpt.is_file()
    scfg.dec_dict["vae_dict"]["vqvae_ckp_path"] = str(ckpt)
    model = build_model(scfg, device="cpu")
    assert graft_pretrained(model, scfg)
    got = model.dm_decoder.vae.vqvae.state_dict()
    want = stage1.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    z = torch.from_numpy(np.random.RandomState(5).randn(
        2, 4, 4, 3).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(model.dm_decoder.vae.decode(z, quantize=False),
                           stage1.decode(z))


def _write_steve_tree(root, split, n_videos, frames, res, seed):
    """A STEVE-MOVi split: `{frame:08d}_image.png` and 10 binary masks
    `{frame:08d}_mask_{k:02d}.png` a frame, objects as random squares."""
    from PIL import Image
    r = np.random.RandomState(seed)
    for v in range(n_videos):
        d = os.path.join(root, "MOVi-Solid", split, f"{v:05d}")
        os.makedirs(d)
        for t in range(frames):
            img = r.randint(0, 256, (res, res, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{t:08d}_image.png"))
            for k in range(10):
                m = np.zeros((res, res), np.uint8)
                if k < 3:
                    y, x = r.randint(0, res - 4, 2)
                    m[y:y + 5, x:x + 5] = 255
                Image.fromarray(m).save(
                    os.path.join(d, f"{t:08d}_mask_{k:02d}.png"))


def test_steve_movi_layout_is_the_jax_datasets(tmp_path):
    """VQVAEMoviSolid128's and SAViLDMMoviSolid128's data
    (`dataset="steve_movi"`): PNG frames and 10 binary masks a frame,
    merged by argmax behind a background, no validation split (the test
    split stands in). Both configs' splits give the JAX datasets' lengths
    and items bit for bit."""
    from slotdiffusion_tpu.data.movi import build_movi_dataset
    root = str(tmp_path / "data")
    _write_steve_tree(root, "train", 2, 4, 16, 0)
    _write_steve_tree(root, "test", 2, 4, 16, 1)
    old = os.environ.get("SLOTDIFFUSION_CACHE")
    os.environ["SLOTDIFFUSION_CACHE"] = str(tmp_path / "cache")
    try:
        for name, frames in (("VQVAEMoviSolid128", 1),
                             ("SAViLDMMoviSolid128", 2)):
            cfg = configs.get_config(name).copy(
                data_root=root, resolution=(16, 16), video_len=4,
                n_sample_frames=frames, load_mask=True)
            assert cfg.dataset == "steve_movi"
            p = BaseParams()
            for k in ("dataset", "movi_level", "data_root", "resolution",
                      "n_sample_frames", "frame_offset", "video_len",
                      "load_mask"):
                setattr(p, k, getattr(cfg, k))
            jsets = build_movi_dataset(p)
            sets = build_dataset(cfg)
            assert sets[1].split == "test" and "masks" in sets[1][0]
            for mine, theirs in zip(sets, jsets, strict=True):
                assert len(mine) == len(theirs) > 0
                for i in range(len(mine)):
                    a, b = mine[i], theirs[i]
                    assert set(a) == set(b)
                    for k in a:
                        np.testing.assert_array_equal(a[k], b[k])
    finally:
        if old is None:
            del os.environ["SLOTDIFFUSION_CACHE"]
        else:
            os.environ["SLOTDIFFUSION_CACHE"] = old


@pytest.mark.parametrize("name", sorted(configs.CONFIGS))
def test_every_config_builds(name):
    """Each port config builds on the CPU the class its `model` names, with
    f32 parameters; a VQ-VAE config's state_dict has exactly the names and shapes that
    convert_vqvae gives the JAX VQVAE of the same dicts (shapes from
    jax.eval_shape, nothing compiled)."""
    cfg = configs.get_config(name)
    model = build_model(cfg, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert type(model).__name__ == cfg.model
    if cfg.model != "VQVAE":
        return
    jm = JaxVQVAE(cfg.enc_dec_dict, cfg.vq_dict)
    shapes = jax.eval_shape(lambda r, x: jm.init(r, {"img": x}),
                            {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, *cfg.resolution, 3)))["params"]
    want = convert_vqvae(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), cfg.enc_dec_dict)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
