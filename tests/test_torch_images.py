"""The port's image family against the JAX package, on the CPU.

Tiny SA and SADiffusion models of the image configs' structure (tests/
torch_parity_helpers.py:tiny_image_config) hold the same seeded weights
on both sides. The same images, timesteps, noise and x_T (numpy, fixed
seeds) go through the JAX model and the port: `DeconvNormAct` against the
flax module, SA's forward, loss and every gradient, SADiffusion's
`encode`, `compute_losses` and `log_images`; the image serving surfaces
(eager, and an artifact reloaded and served); and the image configs
against their JAX config files. Training (`init_reference_`,
`build_method` -> `Trainer`) and the datasets are in
tests/test_torch_image_training.py.

Both sides run slot attention's f32 formula (`use_pallas="auto"`: the
JAX model off the TPU computes that). f32 tolerances are
`rtol=1e-4, atol=1e-5` unless a test says otherwise: the same formulas
summed in another order.
"""

import io
import json
import os
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from slotdiffusion_tpu.models.blocks import DeconvNormAct as JaxDeconv
from slotdiffusion_tpu_torch import serving
from slotdiffusion_tpu_torch.convert import _deconv, convert_model
from slotdiffusion_tpu_torch.models.blocks import DeconvNormAct
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, build_pair, images,
                                  jax_sad_loss, t2n, tiny_image_config)

TOL = dict(rtol=1e-4, atol=1e-5)
B = 2
LAT = (RES[0] // 4, RES[1] // 4, 3)


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
    return build_pair(cfg=tiny_image_config("SADiffusion"))


def _jit(jm, fn):
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=fn))


# ---- DeconvNormAct ---------------------------------------------------------

@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_deconv_norm_act_matches_flax(k, s):
    """The port's ConvTranspose2d(k, s, padding=k // 2, output_padding=s -
    1) + ReLU against the flax module on the same seeded kernel and input:
    the output is s times the input and equal in value, so the crop is
    the JAX module's (lo = k - 1 - k // 2, hi = lo + s - 1). At stride 2
    flax's "SAME" split of the same kernel shifts the pixels and must
    differ, so the value check sees the crop."""
    r = np.random.RandomState(k * 10 + s)
    x = r.randn(2, 5, 6, 4).astype(np.float32)
    jmod = JaxDeconv(out_channels=3, kernel_size=k, stride=s)
    params = {"ConvTranspose_0": {
        "kernel": r.randn(k, k, 4, 3).astype(np.float32) / np.sqrt(4 * k * k),
        "bias": 0.1 * r.randn(3).astype(np.float32)}}
    want = np.asarray(jmod.apply({"params": params}, x))
    port = DeconvNormAct(4, 3, k, s)
    sd = {}
    _deconv(sd, "0", params["ConvTranspose_0"])
    port.load_state_dict({n: torch.from_numpy(v.copy())
                          for n, v in sd.items()})
    with torch.no_grad():
        got = t2n(port(torch.from_numpy(x).permute(0, 3, 1, 2))
                  ).transpose(0, 2, 3, 1)
    assert got.shape == (2, 5 * s, 6 * s, 3)
    np.testing.assert_allclose(got, want, **TOL)
    if s == 2:
        same = fnn.ConvTranspose(3, (k, k), strides=(s, s), padding="SAME")
        other = np.maximum(np.asarray(same.apply(
            {"params": params["ConvTranspose_0"]}, x)), 0)
        assert other.shape == want.shape
        assert np.abs(other - want).max() > 1e-2


# ---- SA ------------------------------------------------------------------

@pytest.fixture(scope="module")
def sa_jax_loss_and_grads(sa):
    _, jm, jv, _ = sa

    def loss(params, img):
        _, losses = jm.apply({"params": params}, {"img": img},
                             method=jm.compute_losses)
        return losses["img_recon_loss"]

    vg = jax.jit(jax.value_and_grad(loss))
    value, grads = vg(jv["params"], jnp.asarray(images()))
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def test_sa_forward_loss_and_every_gradient_match_jax(sa,
                                                      sa_jax_loss_and_grads):
    """Slots, the image, each slot's RGB and alpha masks, and the MSE
    `img_recon_loss`; then every gradient against `jax.grad`, rtol 1e-4
    and atol 2e-5 of the leaf's largest gradient, or of a hundredth of the
    model's largest where that is larger: f32 sums through the encoder,
    3 iterations and 4 deconvs, and a leaf whose gradient is zero in
    exact arithmetic (slot attention's q-LN bias: the softmax over the
    slots drops a shift shared by every q) holds f32 noise (~1e-14), as
    in tests/test_torch_train.py."""
    cfg, jm, jv, tm = sa
    img = images()
    ref = _jit(jm, lambda m, x: m({"img": x}))(jv, img)
    model = tm.train()
    model.zero_grad(set_to_none=True)
    out, losses = model.compute_losses({"img": torch.from_numpy(img)})
    assert out["masks"].shape == (B, SLOTS, *RES, 1)
    assert out["recons"].shape == (B, SLOTS, *RES, 3)
    for k in ("slots", "recon_img", "recons", "masks"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(t2n(out["masks"].sum(1)), 1.0, atol=1e-6)
    want_loss, jgrads = sa_jax_loss_and_grads
    losses["img_recon_loss"].backward()
    np.testing.assert_allclose(losses["img_recon_loss"].item(), want_loss,
                               rtol=1e-5)
    want = convert_model(jgrads, cfg)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == set(grads)
    floor = 1e-2 * max(g.abs().max().item() for g in want.values())
    for name, w in want.items():
        assert w.abs().max() > 0, name
        np.testing.assert_allclose(
            t2n(grads[name]), t2n(w), rtol=1e-4,
            atol=2e-5 * max(w.abs().max().item(), floor), err_msg=name)
    model.zero_grad(set_to_none=True)
    model.eval()


def test_sa_testing_returns_the_slots_only(sa):
    _, _, _, tm = sa
    with torch.no_grad():
        out = tm({"img": torch.from_numpy(images())}, testing=True)
    assert set(out) == {"slots"} and out["slots"].shape == (B, SLOTS,
                                                             SLOT_SIZE)


# ---- SADiffusion ---------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_sadiffusion_encode_matches_jax(sad, train):
    """Slots and masks: at the visual resolution (4x4) when `train`, else
    bilinearly upsampled to 16x16."""
    _, jm, jv, tm = sad
    img = images()
    ref = _jit(jm, lambda m, x: m({"img": x}, train=train))(jv, img)
    with torch.no_grad():
        out = tm({"img": torch.from_numpy(img)}, train=train)
    side = (4, 4) if train else RES
    assert out["masks"].shape == (B, SLOTS, *side)
    for k in ("slots", "masks"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]), **TOL,
                                   err_msg=k)


def _draws(seed=4):
    r = np.random.RandomState(seed)
    return (r.randint(0, 10, size=B).astype(np.int32),
            r.randn(B, *LAT).astype(np.float32))


def test_sadiffusion_compute_losses_matches_jax(sad):
    """The denoising loss of 2 images at fixed timesteps and latent noise,
    rtol 1e-5."""
    _, jm, jv, tm = sad
    t, noise = _draws()
    want = _jit(jm, jax_sad_loss)(jv, images(), t, noise)
    with torch.no_grad():
        out, losses = tm.compute_losses(
            {"img": torch.from_numpy(images())}, t=torch.from_numpy(t).long(),
            noise=torch.from_numpy(noise))
    assert out["masks"].shape == (B, SLOTS, 4, 4)
    np.testing.assert_allclose(losses["denoise_loss"].item(), float(want),
                               rtol=1e-5)


def test_sadiffusion_log_images_dpm_matches_jax(sad):
    """`log_images` by DPM-Solver++ (one second-order step, from the same
    x_T), VQ decode, against the JAX model's encode -> `sample_dpm` ->
    `decode_latent` (what its `log_images` runs, at the 20 steps of
    order 3 its signature fixes: one step of order 2, two UNet calls,
    keeps the JAX program's compile short; the orders themselves are
    held in tests/test_torch_samplers.py). The masks come at 16x16."""
    _, jm, jv, tm = sad
    img = images()
    x_T = np.random.RandomState(5).randn(B, *LAT).astype(np.float32)

    def f(m, x, xt):
        out = m({"img": x}, train=False)
        dm = m.dm_decoder
        z = dm.sample_dpm(jax.random.PRNGKey(0), cond=out["slots"], steps=2,
                          order=2, x_T=xt)
        return dm.decode_latent(z), out["masks"]

    want, masks = _jit(jm, f)(jv, img, x_T)
    with torch.no_grad():
        got = tm.log_images({"img": torch.from_numpy(img)}, steps=2,
                            order=2, x_T=torch.from_numpy(x_T))
    assert got["samples"].shape == (B, *RES, 3) and "intermed" not in got
    np.testing.assert_allclose(t2n(got["masks"]), np.asarray(masks), **TOL)
    np.testing.assert_allclose(t2n(got["samples"]), np.asarray(want), **TOL)


def test_sadiffusion_log_images_ddim_intermediates_match_jax(sad):
    """`log_images(ret_intermed=True)`: DDIM over the 10 timesteps from the
    same x_T, the final images and every VQ-decoded intermediate
    [K, B, H, W, 3] (x_T first) against the JAX model's `log_images`."""
    _, jm, jv, tm = sad
    img = images()
    x_T = np.random.RandomState(6).randn(B, *LAT).astype(np.float32)
    want = _jit(jm, lambda m, x, xt: m.log_images(
        {"img": x}, jax.random.PRNGKey(0), ret_intermed=True, x_T=xt))(
            jv, img, x_T)
    with torch.no_grad():
        got = tm.log_images({"img": torch.from_numpy(img)}, ret_intermed=True,
                            x_T=torch.from_numpy(x_T))
    assert got["intermed"].shape == want["intermed"].shape
    assert got["intermed"].shape[1:] == (B, *RES, 3)
    for k in ("samples", "intermed"):
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), **TOL,
                                   err_msg=k)
    # `ret_intermed` alone picks DDIM, as in the JAX model, which passes
    # `use_ddim=ret_intermed` and so refuses a caller's `use_ddim`
    for ret in (False, True):
        with pytest.raises(TypeError), torch.no_grad():
            tm.log_images({"img": torch.from_numpy(img)}, use_ddim=True,
                          ret_intermed=ret)


# ---- serving ----------------------------------------------------------------

def test_image_serving_surfaces_and_an_artifact(sad, tmp_path):
    """SADiffusion's image surfaces, eagerly on the CPU: `encode` equals
    the model's forward, `sample` the model's DPM-Solver++ from the same
    seed's x_T then VQ decode, `denoise` the decoder's; the `encode`
    artifact reloaded, and served by `scripts/serve_model_torch.py`,
    gives the same bits."""
    cfg, _, _, model = sad
    img = torch.from_numpy(images(9))
    (encode, ex), sample, denoise = (
        serving.build_serving_fn(model, "encode",
                                 serving.data_shape(cfg, B)),
        serving.build_serving_fn(model, "sample"),
        serving.build_serving_fn(model, "denoise"))
    assert tuple(ex[0].shape) == (B, *RES, 3)
    slots, masks = encode(img)
    with torch.no_grad():
        ref = model({"img": img})
        x_T = serving.draw_noise(3, (B, *LAT), "cpu")
        want = model.dm_decoder.decode_latent(
            model.dm_decoder.sample_dpm(cond=slots, x_T=x_T))
        x_t = torch.randn(B, *LAT, generator=torch.Generator()
                          .manual_seed(1))
        tt = torch.tensor([1.0, 7.0])
        d_ref = model.dm_decoder.denoise(x_t, tt, slots)
    assert torch.equal(slots, ref["slots"]) and \
        torch.equal(masks, ref["masks"])
    assert torch.equal(sample(3, slots), want)
    assert torch.equal(denoise(x_t, tt, slots), d_ref)
    path = str(tmp_path / "encode.pt2")
    header = serving.save_artifact(path, encode, ex, meta={"what": "encode"})
    assert header["args"][0]["shape"] == [B, *RES, 3]
    call, _ = serving.load_artifact(path)
    s2, m2 = call(img)
    assert torch.equal(s2, slots) and torch.equal(m2, masks)
    # behind scripts/serve_model_torch.py: /health and one /predict
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    from serve_model_torch import make_server
    srv = make_server(path, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        health = json.loads(urllib.request.urlopen(f"{base}/health",
                                                   timeout=30).read())
        assert health["surface"] == "encode" and \
            health["args"][0]["shape"] == [B, *RES, 3]
        buf = io.BytesIO()
        np.savez(buf, arg0=img.numpy())
        req = urllib.request.Request(f"{base}/predict", buf.getvalue(),
                                     method="POST")
        out = np.load(io.BytesIO(urllib.request.urlopen(req, timeout=60)
                                 .read()))
        np.testing.assert_array_equal(out["out0"], t2n(slots))
        np.testing.assert_array_equal(out["out1"], t2n(masks))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)


# ---- configs ----------------------------------------------------------------

# the port's knobs (kernel routes) and the JAX keys no port module reads,
# each at the value the port's default stands for
PORT_ONLY = {"use_pallas", "fused_gn", "attn_backend"}
JAX_ONLY = {"cosine_s": 8e-3, "log_every_t": 200, "logvar_init": 0.0,
            "use_ema": False, "cond_stage_key": "slots",
            "vqvae_ckp_path": None, "percept_loss_w": None}


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return [_plain(x) for x in v] if isinstance(v, (list, tuple)) else v


def _same_config(mine, ref, where):
    for k in set(mine) | set(ref):
        if k not in ref:
            assert k in PORT_ONLY, f"{where}.{k}"
        elif k not in mine:
            assert k in JAX_ONLY, f"{where}.{k}"
            if JAX_ONLY[k] is not None:
                assert ref[k] == JAX_ONLY[k], f"{where}.{k}"
        elif isinstance(ref[k], dict):
            _same_config(mine[k], ref[k], f"{where}.{k}")
        else:
            assert mine[k] == ref[k], (f"{where}.{k}", mine[k], ref[k])


@pytest.mark.parametrize("name,path", [
    ("SACLEVRTex128", "img_based/sa/sa_clevrtex_params-res128.py"),
    ("SACelebA128", "img_based/sa/sa_celeba_params-res128.py"),
    ("SALDMCLEVRTex128", "img_based/sa_ldm/sa_ldm_clevrtex_params-res128.py"),
    ("SALDMCelebA128", "img_based/sa_ldm/sa_ldm_celeba_params-res128.py"),
    ("VQVAECLEVRTex128", "img_based/sa_ldm/vqvae_clevrtex_params-res128.py"),
    ("VQVAECelebA128", "img_based/sa_ldm/vqvae_celeba_params-res128.py"),
    ("SASyntheticLong64", "sa_synthetic_long-res64.py"),
    ("SALDMSyntheticLong64", "sa_ldm_synthetic_long-res64.py")])
def test_image_configs_match_the_jax_config_files(name, path):
    """Every setting the port's config shares with its JAX config file
    (training, data, the model's nested dicts) is equal, but the port's
    kernel knobs and the JAX keys no port module reads (each at the value
    the port's default stands for)."""
    from slotdiffusion_tpu.utils import load_params
    from slotdiffusion_tpu_torch import configs
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = load_params(os.path.join(repo, "configs", path))
    mine = configs.get_config(name)
    keys = [k for k in dir(mine) if not k.startswith("_") and
            not callable(getattr(mine, k)) and ref.has(k)]
    assert {"model", "lr", "slot_dict" if name[:2] == "SA" else "vq_dict",
            "train_batch_size", "dataset"} <= set(keys)
    _same_config({k: _plain(getattr(mine, k)) for k in keys},
                 {k: _plain(ref.get(k)) for k in keys}, name)
