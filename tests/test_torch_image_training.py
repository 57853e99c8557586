"""The port's image family against the JAX package, on the CPU: training
and what it reads.

- `build_method` -> `Trainer` steps of the tiny SA and SADiffusion
  (tests/torch_parity_helpers.py:tiny_image_config) against the JAX
  losses and gradient norms on the same seeded weights, images,
  timesteps and noise;
- `init_reference_` against flax's init for the image modules;
- the synthetic, CLEVRTex and CelebA datasets on small generated trees
  against the JAX datasets: the same arrays, splits and `max_obj`
  filtering.

The models' own parity is in tests/test_torch_images.py. Both sides run
slot attention's f32 formula (`use_pallas="auto"`).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.utils import BaseParams
from slotdiffusion_tpu_torch.convert import convert_model
from slotdiffusion_tpu_torch.data import build_datamodule, build_dataset
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.models import build_model, init_reference_
from test_data_layouts import _make_clevrtex
from torch_parity_helpers import (RES, build_pair, images, jax_params_of,
                                  jax_sad_loss, tiny_image_config)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: this file's ops are small, and beside other
    test processes more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sa():
    return build_pair(cfg=tiny_image_config("SA"))


@pytest.fixture(scope="module")
def sad():
    """The tiny SADiffusion with SA's plain CNN encoder and attention at
    one UNet level: the trainer's wiring does not depend on the widths,
    and the JAX gradient of the smaller model compiles in half the
    time."""
    cfg = tiny_image_config("SADiffusion")
    unet = dict(cfg.dec_dict["unet_dict"], attention_resolutions=(2,))
    return build_pair(cfg=cfg.copy(
        enc_dict=tiny_image_config("SA").enc_dict,
        dec_dict=dict(cfg.dec_dict, unet_dict=unet)))


def _value_and_grad(jm, fn):
    """jit of (params, *inputs) -> (`fn`'s value, its gradients)."""
    vg = jax.jit(jax.value_and_grad(
        lambda p, *a: jm.apply({"params": p}, *a, method=fn)))
    return lambda params, *a: vg(params, *map(jnp.asarray, a))


def _sa_loss(m, img):
    return m.compute_losses({"img": img})[1]["img_recon_loss"]


# ---- build_method -> Trainer ---------------------------------------------

def test_sa_trainer_step_weights_and_grad_norm_match_jax(sa):
    """One `Trainer.train_step` of SA on the loss's batch, with the
    config's `img_recon_loss_w` at 0.5: `train/img_recon_loss` is the JAX
    loss, `train/total_loss` half of it and `train/grad_norm` half of
    `optax.global_norm` of the JAX gradients (the JAX trainer weights
    `foo_loss` by `foo_loss_w`), rtol 1e-5; then `fit` to 2 steps and
    `validate` with the segmentation metrics of the decoder's masks."""
    cfg, jm, jv, tm = sa
    cfg = cfg.copy(img_recon_loss_w=0.5, print_iter=1)
    model = copy.deepcopy(tm)
    trainer = build_method(model, build_datamodule(cfg.copy(num_workers=0)),
                           cfg)
    assert trainer.ema is None and \
        len(trainer.optimizer.core.param_groups) == 1
    m = trainer.train_step({"img": torch.from_numpy(images())})
    want, jgrads = _value_and_grad(jm, _sa_loss)(jv["params"], images())
    want = float(want)
    np.testing.assert_allclose(m["train/img_recon_loss"], want, rtol=1e-5)
    np.testing.assert_allclose(m["train/total_loss"], 0.5 * want, rtol=1e-5)
    np.testing.assert_allclose(
        m["train/grad_norm"], 0.5 * float(optax.global_norm(jgrads)),
        rtol=1e-5)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    last = trainer.fit(max_steps=2)
    assert trainer.step == 2 and np.isfinite(last["train/img_recon_loss"])
    assert all(not torch.equal(p, start[n])
               for n, p in model.named_parameters())
    res = trainer.validate()
    assert set(res) == {f"val/{k}" for k in ("img_recon_loss", "ari", "fari",
                                             "miou", "fmiou", "mbo")}
    assert all(np.isfinite(v) for v in res.values())


def test_sadiffusion_trainer_step_and_grad_norm_match_jax(sad):
    """One `Trainer.train_step` of SADiffusion at fixed timesteps and
    noise: `train/denoise_loss` and `train/grad_norm` against the JAX
    loss and `optax.global_norm` of its gradients, rtol 1e-5; the
    dm_decoder's LR group at `dec_lr`, the VQ-VAE frozen; then `fit` to 2
    steps and `validate` (losses, the EMA's when the decoder asks for
    one, and the segmentation metrics)."""
    cfg, jm, jv, tm = sad
    cfg = cfg.copy(print_iter=1, use_ema=True)
    model = copy.deepcopy(tm)
    trainer = build_method(model, build_datamodule(cfg.copy(num_workers=0)),
                           cfg)
    lrs = sorted(g["lr"] for g in trainer.optimizer.core.param_groups)
    assert trainer.ema is not None and len(lrs) == 2
    r = np.random.RandomState(7)
    t = r.randint(0, 10, size=2).astype(np.int32)
    noise = r.randn(2, RES[0] // 4, RES[1] // 4, 3).astype(np.float32)
    compute = model.compute_losses
    model.compute_losses = lambda batch, gen: compute(
        batch, t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    m = trainer.train_step({"img": torch.from_numpy(images(3))})
    value, grads = _value_and_grad(jm, jax_sad_loss)(
        jv["params"], images(3), t, noise)
    np.testing.assert_allclose(m["train/denoise_loss"], float(value),
                               rtol=1e-5)
    np.testing.assert_allclose(m["train/grad_norm"],
                               float(optax.global_norm(grads)), rtol=1e-5)
    model.compute_losses = compute
    vae = {n: p.detach().clone()
           for n, p in model.dm_decoder.vae.named_parameters()}
    trainer.fit(max_steps=2)
    assert trainer.step == 2
    for n, p in model.dm_decoder.vae.named_parameters():
        assert not p.requires_grad and torch.equal(p, vae[n]), n
    res = trainer.validate()
    assert {"val/denoise_loss", "val/denoise_loss_ema", "val/fari",
            "val/miou", "val/mbo"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())


# ---- init_reference_ ------------------------------------------------------

# as tests/test_torch_init.py: 16 inits a side, each leaf's std pooled over
# them; the smallest drawn leaf here (the decoder's position embedding, 4 x
# 32) is good to about +-3 % a side, so +-25 % is far outside the noise
DRAWS, STD_BAND = 16, 0.25


def test_reference_init_matches_flax_for_the_image_modules():
    """SA (plain CNN encoder, spatial broadcast decoder): the same leaves;
    biases exactly 0 and norm scales 1 on both sides; `init_latents`
    N(0, 1); every other leaf's std, pooled over 16 inits, within 25 % of
    flax's: the deconvs' `conv_kernel_init` over flax's fans (C_in * k^2,
    not torch's), the encoder convs', the 1x1 conv's and the position
    embeddings' lecun normal."""
    cfg = tiny_image_config("SA")
    jm = build_jax_model(jax_params_of(cfg))
    img = jnp.asarray(images())
    init = jax.jit(lambda key: jm.init({"params": key}, {"img": img})[
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
        else:
            ratio = (p.std() / j.std()).item()
            checked += 1
            if not abs(ratio - 1) <= STD_BAND:
                bad.append((n, ratio))
            assert abs(p.mean().item()) <= 0.25 * j.std().item(), n
    lat = torch.cat([s["init_latents"].flatten() for s in pstates])
    assert 0.8 <= lat.std().item() <= 1.2
    assert checked >= 10 and not bad, bad
    assert any("decoder.decoder.0.0" in n for n in pstates[0])


# ---- datasets --------------------------------------------------------------

def _same(mine, ref):
    assert set(mine) == set(ref)
    for k in ref:
        assert np.asarray(mine[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def test_synthetic_images_match_the_jax_dataset():
    """`build_dataset` of a "synthetic" config: the JAX builder's split
    sizes and seeds (train 0, val 1), bit-identical samples."""
    from slotdiffusion_tpu.data.builders import build_dataset as jax_build
    cfg = tiny_image_config("SA").copy(train_samples=3, val_samples=2,
                                       resolution=(24, 20))
    p = BaseParams()
    for k in ("dataset", "resolution", "train_samples", "val_samples",
              "max_objects", "load_mask"):
        if hasattr(cfg, k):
            setattr(p, k, getattr(cfg, k))
    mine, ref = build_dataset(cfg), jax_build(p)
    for a, b in zip(mine, ref):
        assert len(a) == len(b)
        for i in range(len(b)):
            _same(a[i], b[i])
    assert "masks" in mine[1][0]


@pytest.mark.parametrize("max_obj", [-1, 4])
def test_clevrtex_matches_the_jax_dataset(tmp_path, monkeypatch, max_obj):
    """A generated CLEVRTex tree (tests/test_data_layouts.py's): the same
    0.1/0.1/0.8 splits, `max_obj` filter (even scenes 2 objects, odd 6)
    and bit-identical crops, images and masks; the second build reads the
    index cache."""
    from slotdiffusion_tpu.data import clevrtex as jct
    monkeypatch.setattr(jct, "CACHE_DIR", str(tmp_path / "jcache"))
    monkeypatch.setenv("SLOTDIFFUSION_CACHE", str(tmp_path / "cache"))
    _make_clevrtex(tmp_path, n=20,
                   n_obj_of=lambda i: 2 if i % 2 == 0 else 6)
    cfg = tiny_image_config("SA").copy(dataset="clevrtex",
                                       data_root=str(tmp_path),
                                       resolution=(24, 24), max_obj=max_obj)
    p = BaseParams()
    for k in ("data_root", "resolution", "load_mask", "max_obj"):
        setattr(p, k, getattr(cfg, k))
    ref = (*jct.build_clevrtex_dataset(p),
           jct.build_clevrtex_dataset(p, val_only=True))
    mine = (*build_dataset(cfg), build_dataset(cfg, val_only=True))
    sizes = [len(d) for d in mine]
    assert sizes == [len(d) for d in ref]
    assert sizes == ([16, 2, 2] if max_obj < 0 else [8, 1, 1])
    for a, b in zip(mine, ref):
        assert a.img_index == b.img_index and a.bias == b.bias
        for i in range(len(b)):
            _same(a[i], b[i])
    assert os.listdir(tmp_path / "cache")
    again = build_dataset(cfg)[0]
    assert again.img_index == mine[0].img_index


def test_celeba_matches_the_jax_dataset(tmp_path):
    """A generated CelebA tree: the splits of `list_eval_partition.txt` and
    no masks. Every image equals the JAX dataset's bit for bit: the port
    decodes the JPEGs as libjpeg-turbo does and resizes them with PIL's
    BILINEAR arithmetic (`data/imageio.py`), the JAX dataset's path."""
    from slotdiffusion_tpu.data.celeba import build_celeba_dataset
    img_dir = tmp_path / "img_align_celeba"
    os.makedirs(img_dir)
    r = np.random.RandomState(0)
    lines = []
    for i, split_id in enumerate([0, 0, 0, 1, 1, 2]):
        name = f"{i:06d}.jpg"
        Image.fromarray((r.rand(48, 40, 3) * 255).astype(np.uint8)).save(
            img_dir / name)
        lines.append(f"{name} {split_id}")
    (tmp_path / "list_eval_partition.txt").write_text("\n".join(lines))
    cfg = tiny_image_config("SA").copy(dataset="celeba",
                                       data_root=str(tmp_path),
                                       resolution=(32, 32), load_mask=False)
    p = BaseParams()
    p.data_root, p.resolution = str(tmp_path), (32, 32)
    ref = (*build_celeba_dataset(p), build_celeba_dataset(p, val_only=True))
    mine = (*build_dataset(cfg), build_dataset(cfg, val_only=True))
    assert [len(d) for d in mine] == [3, 2, 2]
    for a, b in zip(mine, ref):
        assert a.files == b.files
        for i in range(len(b)):
            _same(a[i], b[i])
