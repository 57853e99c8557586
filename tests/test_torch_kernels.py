"""Each kernel of the PyTorch port against the JAX package's Pallas kernel.

On the CPU the port's wrappers run their plain PyTorch versions (a CUDA
kernel has no CPU mode); the JAX side runs the Pallas kernel in interpret
mode, as the JAX package's own kernel tests do. Inputs come from numpy
with a fixed seed and go to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.ops.attention_kernel import fused_mha as jax_mha
from slotdiffusion_tpu.ops.fused_norm import fused_group_norm as jax_gn
from slotdiffusion_tpu.ops.slot_attention_kernel import sa_iterations_pallas
from slotdiffusion_tpu_torch import ops
from slotdiffusion_tpu_torch.models.blocks import GroupNorm32
from slotdiffusion_tpu_torch.ops.attention_kernel import fused_mha
from slotdiffusion_tpu_torch.ops.fused_norm import fused_group_norm
from slotdiffusion_tpu_torch.ops.slot_attention_kernel import (
    SA_WEIGHT_KEYS, sa_iterations)

# f32 on both sides, the same formula with sums taken in another order:
# differences are a few f32 ulps of O(1) values
F32_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (2, 4, 4, 256)])
@pytest.mark.parametrize("act,eps", [(None, 1e-6), ("silu", 1e-5)])
def test_group_norm_matches_pallas(shape, act, eps):
    r = np.random.RandomState(0)
    x = (r.randn(*shape) * 2 + 0.5).astype(np.float32)
    C = shape[-1]
    w = (1 + 0.1 * r.randn(C)).astype(np.float32)
    b = (0.1 * r.randn(C)).astype(np.float32)
    ref = np.asarray(jax_gn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            32, eps, act, True))  # interpret=True
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()  # NCHW
    out = fused_group_norm(xt, torch.from_numpy(w), torch.from_numpy(b), 32,
                           eps, act)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               **F32_TOL)
    gn = GroupNorm32(C, eps=eps, act=act, fused=True)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(w))
        gn.bias.copy_(torch.from_numpy(b))
        np.testing.assert_allclose(
            gn(xt).permute(0, 2, 3, 1).numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("nq,nk,hd,heads", [
    (256, 256, 256, 8),    # ds2 self-attention
    (64, 64, 384, 12),     # ds4 self-attention
    (16, 16, 512, 16),     # ds8/mid self-attention
    (256, 15, 256, 8),     # ds2 cross-attention over 15 slots
    (64, 15, 384, 12),     # ds4 cross-attention
])
def test_attention_matches_pallas(nq, nk, hd, heads):
    r = np.random.RandomState(1)
    q, k, v = (r.randn(1, n, hd).astype(np.float32) for n in (nq, nk, nk))
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             heads, None, True))  # interpret=True
    out = fused_mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), heads)
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


def _sa_weights(D, M, seed=0):
    r = np.random.RandomState(seed)
    g = lambda *s: (r.randn(*s) * 0.2).astype(np.float32)
    p = {"wq": g(D, D), "gru_wi": g(D, 3 * D), "gru_wh": g(D, 3 * D),
         "w1": g(D, M), "w2": g(M, D)}
    for key, n in (("ln_q_bias", D), ("gru_bi", 3 * D), ("gru_bh", 3 * D),
                   ("ln_mlp_bias", D), ("b1", M), ("b2", D)):
        p[key] = g(n) * 0.5
    p["ln_q_scale"] = 1 + g(D) * 0.5
    p["ln_mlp_scale"] = 1 + g(D) * 0.5
    return p


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,S,D,iters", [
    (2, 256, 5, 64, 2),   # slot padding on the JAX side (5 -> 8)
    (1, 64, 15, 32, 3),   # the flagship's 15 slots, 3 iterations
])
def test_slot_attention_matches_pallas(kv, B, N, S, D, iters):
    p = _sa_weights(D, 2 * D)
    r = np.random.RandomState(2)
    k, v = (r.randn(B, N, D).astype(np.float32) for _ in range(2))
    slots = r.randn(B, S, D).astype(np.float32)
    ref, ref_mask = sa_iterations_pallas(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots),
        {key: jnp.asarray(val) for key, val in p.items()},
        num_iterations=iters, eps=1e-6, return_last_attn=True,
        interpret=True, kv_dtype=getattr(jnp, kv))
    out, mask = sa_iterations(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(slots),
        {key: torch.from_numpy(p[key]) for key in SA_WEIGHT_KEYS},
        num_iterations=iters, eps=1e-6, return_last_attn=True,
        kv_dtype=getattr(torch, kv))
    # bf16: q, k, v and the attention weights are rounded to bf16 at the
    # same points on both sides, so only a value whose f32 sum lands on the
    # other side of a rounding boundary differs, by one bf16 ulp (2^-8) in
    # one term of a D-long sum: ~1e-5 on slots of magnitude ~10
    tol = F32_TOL if kv == "float32" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref_mask), **tol)


def test_wrappers_launch_or_raise_off_the_cpu():
    """Off the CPU a wrapper launches its kernel or raises; it never takes
    its plain version. A `meta` tensor is neither CPU nor CUDA."""
    ops.reset_launch_counts()
    x = torch.empty(1, 32, 4, 4, device="meta")
    w = torch.empty(32, device="meta")
    with pytest.raises(ValueError):
        fused_group_norm(x, w, w, 32)
    q = torch.empty(1, 16, 64, device="meta")
    with pytest.raises(ValueError):
        fused_mha(q, q, q, 2)
    k = torch.empty(1, 16, 32, device="meta")
    with pytest.raises(ValueError):
        sa_iterations(k, k, k[:, :4], {}, num_iterations=1, eps=1e-6)
    # the CPU path is the plain version and launches nothing
    fused_group_norm(torch.ones(1, 32, 4, 4), torch.ones(32),
                     torch.zeros(32), 32)
    assert ops.launch_counts() == {
        "gn_silu": 0, "attention": 0, "slot_attention": 0}
