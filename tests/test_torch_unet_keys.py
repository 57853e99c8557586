"""The UNet keys `conv_resample`, `resblock_updown` and `use_checkpoint`
of the JAX `CondDDPM` (models/diffusion.py:108-111) in the port.

A tiny JAX `UNetModel` with each key set is given seeded weights,
`slotdiffusion_tpu_torch.convert.convert_unet` carries them into the
port's `UNetModel` (a strict load), and both run the same numpy inputs on
the CPU. `use_checkpoint` is also held where it matters in the port:
the gradients of a checkpointed UNet with dropout on equal the plain
UNet's, with the masks drawn from the same generator seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.models.unet import UNetModel as JaxUNet
from slotdiffusion_tpu_torch.convert import convert_unet
from slotdiffusion_tpu_torch.models.unet import UNetModel
from torch_parity_helpers import random_params, t2n

# f32 on both sides with the same formulas, sums in another order
TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = dict(in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_head_channels=32, context_dim=16)
KEYS = [dict(resblock_updown=True), dict(conv_resample=False),
        dict(resblock_updown=True, conv_resample=False),
        dict(use_checkpoint=True)]


def _inputs(seed=1):
    r = np.random.RandomState(seed)
    return (r.randn(2, 8, 8, 3).astype(np.float32),
            np.array([3.0, 41.5], np.float32),
            r.randn(2, 5, 16).astype(np.float32))


def _port_unet(keys, dropout=0.0, seed=0):
    """A port UNet with the seeded weights of the JAX UNet of `keys`, and
    the JAX side: -> (jax module, jax params, port module)."""
    jnet = JaxUNet(**ARCH, **keys)
    x, t, ctx = _inputs()
    shapes = jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(t), jnp.asarray(ctx)))["params"]
    params = random_params(shapes, seed)
    net = UNetModel(**ARCH, **keys, dropout=dropout)
    sd = convert_unet(params, ARCH["num_res_blocks"], ARCH["channel_mult"],
                      ARCH["attention_resolutions"],
                      resblock_updown=keys.get("resblock_updown", False),
                      conv_resample=keys.get("conv_resample", True))
    net.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in sd.items()}, strict=True)
    return jnet, params, net.eval()


@pytest.mark.parametrize("keys", KEYS, ids=lambda k: ",".join(
    f"{n}={v}" for n, v in k.items()))
def test_unet_key_matches_jax(keys):
    jnet, params, net = _port_unet(keys)
    x, t, ctx = _inputs()
    ref = jax.jit(lambda p, *a: jnet.apply({"params": p}, *a))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(t2n(out.permute(0, 2, 3, 1)), np.asarray(ref),
                               **TOL)


def _grads(net, seed):
    """Gradients of a fixed random projection of the train-mode output,
    dropout masks drawn from a generator seeded with `seed`."""
    x, t, ctx = (torch.from_numpy(a) for a in _inputs())
    net.train().zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(seed)
    out = net(x.permute(0, 3, 1, 2), t, ctx, generator=gen)
    proj = torch.from_numpy(np.random.RandomState(5).randn(
        *out.shape).astype(np.float32))
    (out * proj).sum().backward()
    return {n: p.grad.clone() for n, p in net.named_parameters()}, \
        gen.get_state()


def test_checkpointed_gradients_equal_plain_with_dropout():
    """Dropout 0.1 (the flagship's rate): the checkpointed UNet recomputes
    each ResBlock in the backward and must draw the same masks there, so
    its gradients equal the plain UNet's (the same operations on the same
    values), and the generator ends where the plain run leaves it."""
    _, _, plain = _port_unet({}, dropout=0.1)
    _, _, ckpt = _port_unet(dict(use_checkpoint=True), dropout=0.1)
    g_plain, end_plain = _grads(plain, 3)
    g_ckpt, end_ckpt = _grads(ckpt, 3)
    assert torch.equal(end_plain, end_ckpt)
    for n, g in g_plain.items():
        np.testing.assert_allclose(t2n(g_ckpt[n]), t2n(g), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    # the masks matter: another seed moves the gradients
    g_other, _ = _grads(plain, 4)
    assert max((g_other[n] - g).abs().max().item()
               for n, g in g_plain.items()) > 1e-3
