"""The port's frozen DINO ViT against the JAX package's, on the CPU.

- `DINOEncoder` (ViT-S/8, 12 blocks of 384 channels, 6 heads) at a 16x16
  image, on seeded weights converted by `convert.convert_dino` and
  loaded strictly, f32: rtol 1e-4, atol 2e-5 (the same formulas summed in
  another order over 12 blocks);
- one `ViTBlock` in bf16 under the per-layer gates of
  tests/test_torch_bf16.py (the block holds the tanh GELU: d <= 0.6 x
  the bf16 floor), with two controls that must fail the gate: the port
  computing in f32, and the port's bf16 block with the exact erf GELU;
- `load_dino_weights` from an `.npz` of flattened flax paths written from
  the JAX parameters (the JAX loader's format): both packages' encoders
  give the same features, and the trainer's `graft_pretrained` overlays
  it; without the file the weights stay; a file that lacks weights is
  refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.models import dino as jax_dino
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import _flatten, convert_dino
from slotdiffusion_tpu_torch.models import dino
from slotdiffusion_tpu_torch.training.checkpoint import graft_pretrained
from test_torch_bf16 import LAYER_C, _distances, _show, xla
from torch_parity_helpers import random_params, t2n

RES = (16, 16)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed=0, B=2):
    return np.random.RandomState(seed).uniform(
        -1, 1, (B, *RES, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def encoders():
    """(JAX DINOEncoder, its seeded params, the port's with them)."""
    jm = jax_dino.DINOEncoder(patch_size=8)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(_img()))
    params = random_params(shapes["params"], 3)
    tm = dino.DINOEncoder(RES, 8)
    tm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in convert_dino(params).items()},
                       strict=True)
    return jm, params, tm.eval()


def test_dino_encoder_matches_jax(encoders):
    jm, params, tm = encoders
    img = _img(1)
    want = jax.jit(jm.apply)({"params": params}, img)
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    assert got.shape == (2, 2, 2, 384) == want.shape
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4,
                               atol=2e-5)


def _block_pair(params, dtype, approximate=None):
    """The port's ViTBlock holding the JAX block `params`."""
    port = dino.ViTBlock(384, 6, compute_dtype=dtype)
    if approximate is not None:
        port.approximate = approximate
    names = dino.flax_names(1)
    sd = {}
    for path, v in _flatten(params).items():
        name, how = names[f"block0/{path}"]
        sd[name.removeprefix("encoder.layer.0.")] = torch.from_numpy(
            np.ascontiguousarray(dino.relayout(v, how)))
    port.load_state_dict(sd, strict=True)
    return port


def test_vit_block_rounds_as_jax_bf16():
    """The per-layer gate of tests/test_torch_bf16.py on one ViTBlock (a
    bf16 input of 17 tokens): d <= 0.6 floor, as for the other layers
    that hold the tanh GELU; the f32 port and the bf16 port with the erf
    GELU must both fail it."""
    x32 = np.random.RandomState(5).randn(2, 17, 384).astype(np.float32)
    x16 = jnp.asarray(x32, jnp.bfloat16)
    jblocks = {dt: jax_dino.ViTBlock(384, 6, dtype=dt)
               for dt in (jnp.float32, jnp.bfloat16)}
    shapes = jax.eval_shape(jblocks[jnp.float32].init,
                            jax.random.PRNGKey(0), x16)
    params = random_params(shapes["params"], 6)
    v = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    jax16 = xla(lambda v, x: jblocks[jnp.bfloat16].apply(v, x), v, x16)
    jax32 = xla(lambda v, x: jblocks[jnp.float32].apply(v, x), v,
                x16.astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(x16.astype(jnp.float32))).to(BF16)
    with torch.no_grad():
        port16 = _block_pair(params, BF16)(xt)
        port32 = _block_pair(params, torch.float32)(xt)
        erf16 = _block_pair(params, BF16, "none")(xt)
    assert port16.dtype == BF16 and jax16.dtype == jnp.bfloat16
    c = LAYER_C["activation"]
    r = _distances(port16, port32, jax16, jax32)
    _show("ViTBlock", r)
    assert r["floor"] > 0
    assert r["d"] <= c * r["floor"]
    assert r["ctl"] > c * r["floor"], "the f32 control passes"
    erf = _distances(erf16, port32, jax16, jax32)
    _show("ViTBlock, erf GELU under bf16 (control)", erf)
    assert erf["d"] > c * r["floor"], "the erf-GELU control passes"


def _write_npz(path, params):
    """The JAX loader's format: flattened flax paths."""
    np.savez(path, **{k: np.asarray(v) for k, v in _flatten(params).items()})


def test_load_dino_weights_from_the_jax_format(encoders, tmp_path,
                                               monkeypatch):
    jm, params, _ = encoders
    other = random_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.asarray(_img()))["params"], 9)
    path = tmp_path / "dino.npz"
    _write_npz(path, other)
    img = _img(2)
    port = dino.DINOEncoder(RES, 8).eval()
    start = {k: v.clone() for k, v in port.state_dict().items()}
    monkeypatch.delenv(dino.WEIGHTS_ENV, raising=False)
    assert dino.load_dino_weights(port) == (port, False)
    monkeypatch.setenv(dino.WEIGHTS_ENV, str(tmp_path / "absent.npz"))
    assert dino.load_dino_weights(port)[1] is False
    assert all(torch.equal(v, start[k]) for k, v in
               port.state_dict().items())
    monkeypatch.setenv(dino.WEIGHTS_ENV, str(path))
    loaded, jloaded = dino.load_dino_weights(port), \
        jax_dino.load_dino_weights(params)
    assert loaded[1] and jloaded[1]
    want = jax.jit(jm.apply)({"params": jloaded[0]}, img)
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4,
                               atol=2e-5)
    # the trainer's graft overlays every DINO encoder of a model
    holder = torch.nn.Module()
    holder.enc = dino.DINOEncoder(RES, 8)
    assert graft_pretrained(holder, configs.BaseParams())
    for k, v in holder.enc.state_dict().items():
        assert torch.equal(v, port.state_dict()[k]), k
    flat = _flatten(other)
    flat.pop("block3/attn/key/kernel")
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
    with pytest.raises(ValueError, match="lacks 1 DINO weights"):
        dino.load_dino_weights(port)
