"""SADiffusion and SA with the frozen DINO ViT, the port against the JAX
package, on the CPU.

A tiny SADiffusion of the COCO/VOC configs' structure (DINO ViT-S/8 at
16x16 images: 2x2 patch tokens of 384 channels, 3 slots of 32, the tiny
LDM with attention at one UNet level) holds the same seeded weights on
both sides. The same images, timesteps, noise and x_T go through both:
`encode` (slots, and masks bilinearly upsampled 2x2 -> 16x16), the
denoising loss, one `Trainer` step (its loss and gradient norm against
the JAX loss and `optax.global_norm` of its gradients, where DINO's are
zero: the JAX model's `stop_gradient`), and a DPM-Solver++ sample with
VQ decode. The DINO weights stay bit-identical through training, hold
no gradient and are in no optimizer group. SA with DINO: its
reconstruction loss. Both sides run slot attention's f32 formula
(`use_pallas="auto"`). f32 tolerances `rtol=1e-4, atol=1e-5` unless a
test says otherwise.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.data import build_datamodule
from slotdiffusion_tpu_torch.methods.build import build_method
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, build_pair, images,
                                  jax_sad_loss, t2n, tiny_image_config)

TOL = dict(rtol=1e-4, atol=1e-5)
B = 2
LAT = (RES[0] // 4, RES[1] // 4, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_dino_config(model="SADiffusion"):
    cfg = tiny_image_config(model)
    cfg = cfg.copy(enc_dict=configs.dino_enc_dict(SLOT_SIZE, RES),
                   dataset="synthetic_coco", load_anno=True)
    if model == "SADiffusion":
        unet = dict(cfg.dec_dict["unet_dict"], attention_resolutions=(2,))
        cfg.dec_dict = dict(cfg.dec_dict, unet_dict=unet)
    return cfg


@pytest.fixture(scope="module")
def dsad():
    return build_pair(cfg=tiny_dino_config())


def _jit(jm, fn):
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=fn))


@pytest.mark.parametrize("train", [True, False])
def test_encode_matches_jax(dsad, train):
    _, jm, jv, tm = dsad
    img = images()
    ref = _jit(jm, lambda m, x: m({"img": x}, train=train))(jv, img)
    with torch.no_grad():
        out = tm({"img": torch.from_numpy(img)}, train=train)
    side = (2, 2) if train else RES
    assert out["masks"].shape == (B, SLOTS, *side)
    assert out["slots"].shape == (B, SLOTS, SLOT_SIZE)
    for k in ("slots", "masks"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]), **TOL,
                                   err_msg=k)


def _value_and_grad(jm, fn):
    vg = jax.jit(jax.value_and_grad(
        lambda p, *a: jm.apply({"params": p}, *a, method=fn)))
    return lambda params, *a: vg(params, *map(jnp.asarray, a))


def test_trainer_step_matches_jax_and_leaves_dino_frozen(dsad):
    """One `Trainer.train_step` at fixed timesteps and noise: the loss
    and the gradient norm, rtol 1e-5 (the JAX gradient of every DINO
    weight is zero); then `fit` to 2 steps: DINO's weights bit-identical,
    no gradient, in no optimizer group, while the trainable weights
    move; `validate` logs the dual `inst/*` and `sem/*` metrics."""
    cfg, jm, jv, tm = dsad
    cfg = cfg.copy(print_iter=1)
    model = copy.deepcopy(tm)
    dino = model.encoder.encoder.dino
    trainer = build_method(model, build_datamodule(cfg.copy(num_workers=0)),
                           cfg)
    assert dino in model.frozen_modules
    in_opt = {id(p) for g in trainer.optimizer.adam.param_groups
              for p in g["params"]}
    assert not any(id(p) in in_opt for p in dino.parameters())
    r = np.random.RandomState(7)
    t = r.randint(0, 10, size=B).astype(np.int32)
    noise = r.randn(B, *LAT).astype(np.float32)
    compute = model.compute_losses
    model.compute_losses = lambda batch, gen: compute(
        batch, t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    m = trainer.train_step({"img": torch.from_numpy(images(3))})
    value, grads = _value_and_grad(jm, jax_sad_loss)(
        jv["params"], images(3), t, noise)
    jdino = grads["encoder"]["DINOEncoder_0"]
    assert all(not np.asarray(g).any()
               for g in jax.tree_util.tree_leaves(jdino))
    np.testing.assert_allclose(m["train/denoise_loss"], float(value),
                               rtol=1e-5)
    np.testing.assert_allclose(m["train/grad_norm"],
                               float(optax.global_norm(grads)), rtol=1e-5)
    model.compute_losses = compute
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer.fit(max_steps=2)
    for n, p in dino.named_parameters():
        assert not p.requires_grad and p.grad is None, n
        assert torch.equal(p, before[f"encoder.encoder.dino.{n}"]), n
    assert any(p.requires_grad and not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    res = trainer.validate()
    assert {"val/denoise_loss", "val/inst/fari", "val/sem/fari",
            "val/inst/mbo", "val/sem/miou"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())


def test_sample_matches_jax(dsad):
    """DPM-Solver++ (one second-order step, from the same x_T) and VQ
    decode, as tests/test_torch_images.py holds the image model's."""
    _, jm, jv, tm = dsad
    img = images(4)
    x_T = np.random.RandomState(5).randn(B, *LAT).astype(np.float32)

    def f(m, x, xt):
        out = m({"img": x}, train=False)
        dm = m.dm_decoder
        z = dm.sample_dpm(jax.random.PRNGKey(0), cond=out["slots"], steps=2,
                          order=2, x_T=xt)
        return dm.decode_latent(z)

    want = _jit(jm, f)(jv, img, x_T)
    with torch.no_grad():
        got = tm.log_images({"img": torch.from_numpy(img)}, steps=2,
                            order=2, x_T=torch.from_numpy(x_T))
    assert got["samples"].shape == (B, *RES, 3)
    np.testing.assert_allclose(t2n(got["samples"]), np.asarray(want), **TOL)


def test_sa_with_dino_loss_matches_jax():
    _, jm, jv, tm = build_pair(cfg=tiny_dino_config("SA"))
    img = images(5)
    want = _jit(jm, lambda m, x: m.compute_losses({"img": x})[1][
        "img_recon_loss"])(jv, img)
    with torch.no_grad():
        _, losses = tm.compute_losses({"img": torch.from_numpy(img)})
    np.testing.assert_allclose(losses["img_recon_loss"].item(), float(want),
                               rtol=1e-5)
    assert tm.frozen_modules == (tm.encoder.encoder.dino,)
