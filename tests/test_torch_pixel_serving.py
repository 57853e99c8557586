"""The `sample` serving surface of a pixel-space decoder, on the CPU.

A tiny SADiffusion whose decoder has no VQ-VAE (a `dec_dict` without
`vae_dict`: the CondDDPM samples 16x16 images) holds the same seeded
weights in the JAX package and the port. The JAX surface
(`build_serving_fn(..., "sample")`) runs `generate_imgs(use_dpm=True)`:
DPM-Solver++ from x_T ~ `jax.random.normal(PRNGKey(seed))`, its dynamic
thresholding as the x0 correction, no decode. The port's surface gets
the same x_T (rebuilt with `jax.random` here) and must give the same
images, to `atol=1e-4` (20 UNet calls of f32 sums in another order, each
thresholded by a quantile). The port's own surface equals its model's
`sample_dpm` bit for bit from the seed's x_T, and its artifact (two
programs: the UNet step and the thresholding) reloads and serves the
same images.
"""

import jax
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.serving import build_serving_fn as jax_serving_fn
from slotdiffusion_tpu_torch import serving
from torch_parity_helpers import RES, build_pair, images, t2n, \
    tiny_image_config

B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pixel_sad():
    cfg = tiny_image_config("SADiffusion")
    dec = dict(cfg.dec_dict)
    dec.pop("vae_dict")
    dec["resolution"] = RES
    # one UNet level: the JAX surface unrolls 20 UNet calls, and its
    # compile time grows with each
    dec["unet_dict"] = dict(dec["unet_dict"], channel_mult=(1,),
                            attention_resolutions=(1,))
    return build_pair(cfg=cfg.copy(dec_dict=dec))


def test_pixel_sample_matches_the_jax_surface(pixel_sad):
    _, jm, jv, tm = pixel_sad
    with torch.no_grad():
        slots = tm({"img": torch.from_numpy(images(2))})["slots"]
    jfn, _ = jax_serving_fn(jm, jv, "sample", (B, *RES, 3))
    want = np.asarray(jfn(0, t2n(slots)))
    x_T = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                       (B, *RES, 3)), np.float32).copy()
    fn = serving.build_serving_fn(tm, "sample")
    assert fn.module.decode is None
    with torch.inference_mode():
        got = fn.module(torch.from_numpy(x_T), slots)
    assert got.shape == (B, *RES, 3) == want.shape
    np.testing.assert_allclose(t2n(got), want, rtol=0, atol=1e-4)


def test_pixel_sample_surface_and_artifact(pixel_sad, tmp_path):
    _, _, _, tm = pixel_sad
    with torch.no_grad():
        slots = tm({"img": torch.from_numpy(images(3))})["slots"]
        want = tm.dm_decoder.sample_dpm(
            cond=slots, x_T=serving.draw_noise(5, (B, *RES, 3), "cpu"))
    fn, example = serving.build_serving_fn(tm, "sample",
                                           data_shape=(B, *RES, 3))
    got = fn(5, slots)
    assert torch.equal(got, want)
    assert not torch.equal(fn(6, slots), got)
    path = str(tmp_path / "sample.pt2")
    header = serving.save_artifact(path, fn, example)
    assert [p["name"] for p in header["programs"]] == ["denoise",
                                                      "quantize"]
    assert header["sampler"]["latent"] == [*RES, 3]
    call, _ = serving.load_artifact(path)
    np.testing.assert_allclose(t2n(call(5, slots)), t2n(got), rtol=0,
                               atol=1e-6)
