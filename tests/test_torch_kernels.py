"""Each kernel of the PyTorch port against the JAX package's Pallas kernel.

On the CPU the port's wrappers run their plain PyTorch versions (a CUDA
kernel has no CPU mode); the JAX side runs the Pallas kernel in interpret
mode, as the JAX package's own kernel tests do. Inputs come from numpy
with a fixed seed and go to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.ops.attention_kernel import fused_mha as jax_mha
from slotdiffusion_tpu.ops.fused_norm import fused_group_norm as jax_gn
from slotdiffusion_tpu.ops.slot_attention_kernel import sa_iterations_pallas
from slotdiffusion_tpu.ops.slot_attention_kernel import \
    sa_iterations_ref as jax_sa_ref
from slotdiffusion_tpu.ops.winograd_conv import _wino_call as jax_wino_call
from slotdiffusion_tpu.ops.winograd_conv import \
    winograd_conv3x3 as jax_winograd
from slotdiffusion_tpu.ops.winograd_conv import \
    winograd_weights as jax_winograd_weights
from slotdiffusion_tpu_torch import ops
from slotdiffusion_tpu_torch.ops import (attention_kernel, fused_norm,
                                         slot_attention_kernel,
                                         winograd_conv)
from slotdiffusion_tpu_torch.models.blocks import GroupNorm32
from slotdiffusion_tpu_torch.ops.attention_kernel import fused_mha
from slotdiffusion_tpu_torch.ops.fused_norm import fused_group_norm
from slotdiffusion_tpu_torch.ops.slot_attention_kernel import (
    SA_WEIGHT_KEYS, sa_iterations)
from slotdiffusion_tpu_torch.ops.winograd_conv import (
    direct_conv, winograd_conv3x3, winograd_reference)

# f32 on both sides, the same formula with sums taken in another order:
# differences are a few f32 ulps of O(1) values
F32_TOL = dict(rtol=1e-5, atol=2e-5)
# bf16 out on both sides, rounded once from f32 values that differ by a
# few f32 ulps (sums in another order): a value can land one bf16 ulp
# apart, and one bf16 ulp is at most 2^-7 of the value
BF16_OUT_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _to_dtype(x, dtype):
    """A numpy f32 array in `dtype` ("float32" or "bfloat16") for the JAX
    side, and the same values as a torch tensor for the port."""
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (2, 4, 4, 256)])
@pytest.mark.parametrize("act,eps", [(None, 1e-6), ("silu", 1e-5)])
def test_group_norm_matches_pallas(shape, act, eps, dtype):
    """bf16: bf16 x and y on both sides (the JAX kernel writes o_ref.dtype),
    f32 statistics and affine, one rounding."""
    r = np.random.RandomState(0)
    x = (r.randn(*shape) * 2 + 0.5).astype(np.float32)
    C = shape[-1]
    w = (1 + 0.1 * r.randn(C)).astype(np.float32)
    b = (0.1 * r.randn(C)).astype(np.float32)
    xj, xt = _to_dtype(x, dtype)
    ref = jax_gn(xj, jnp.asarray(w), jnp.asarray(b), 32, eps, act,
                 True)  # interpret=True
    assert ref.dtype == xj.dtype
    ref = np.asarray(ref.astype(jnp.float32))
    tol = F32_TOL if dtype == "float32" else BF16_OUT_TOL
    xt = xt.permute(0, 3, 1, 2).contiguous()  # NCHW
    out = fused_group_norm(xt, torch.from_numpy(w), torch.from_numpy(b), 32,
                           eps, act)
    assert out.dtype == xt.dtype
    np.testing.assert_allclose(_np(out.permute(0, 2, 3, 1)), ref, **tol)
    gn = GroupNorm32(C, eps=eps, act=act, fused=True)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(w))
        gn.bias.copy_(torch.from_numpy(b))
        np.testing.assert_allclose(
            _np(gn(xt).permute(0, 2, 3, 1)), ref, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,hd,heads", [
    (256, 256, 256, 8),    # ds2 self-attention
    (64, 64, 384, 12),     # ds4 self-attention
    (16, 16, 512, 16),     # ds8/mid self-attention
    (256, 15, 256, 8),     # ds2 cross-attention over 15 slots
    (64, 15, 384, 12),     # ds4 cross-attention
])
def test_attention_matches_pallas(nq, nk, hd, heads, dtype):
    """bf16: bf16 q/k/v/out on both sides, f32 logits and sums, the
    normalized weights rounded to bf16 before the value product. A weight
    whose f32 value differs in its last bits (sums in another order) can
    round one bf16 ulp apart, which moves an output by 2^-8 of that
    weight's v: rtol 2^-7 and atol 2^-8 of the largest |v| cover it."""
    r = np.random.RandomState(1)
    q, k, v = (r.randn(1, n, hd).astype(np.float32) for n in (nq, nk, nk))
    (qj, qt), (kj, kt), (vj, vt) = (_to_dtype(a, dtype) for a in (q, k, v))
    ref = jax_mha(qj, kj, vj, heads, None, True)  # interpret=True
    assert ref.dtype == qj.dtype
    ref = np.asarray(ref.astype(jnp.float32))
    out = fused_mha(qt, kt, vt, heads)
    assert out.dtype == qt.dtype
    tol = F32_TOL if dtype == "float32" else dict(
        rtol=2.0 ** -7, atol=2.0 ** -8 * float(np.abs(v).max()))
    np.testing.assert_allclose(_np(out), ref, **tol)


def _sa_weights(D, M, seed=0, std=0.2):
    r = np.random.RandomState(seed)
    g = lambda *s: (r.randn(*s) * std).astype(np.float32)
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


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
def test_plain_slot_attention_matches_jax_at_the_flagship_shape(kv):
    """The port's plain version (the CPU path, and what the card's kernel
    is held against) against the JAX package at the flagship's shape: B = 2
    frames, N = 1024 positions, 15 slots of 192, MLP 384, 2 iterations,
    weights of the model's scale (std 1/sqrt(fan-in)).

    f32: against the jnp twin `sa_iterations_ref`, to F32_TOL. bf16: the
    jnp twin never rounds q or the attention weights, so the JAX function
    with the port's rounding points is the Pallas kernel with bf16 k/v, in
    interpret mode. q (5,760 values an iteration) and the weights (30,720)
    are rounded to bf16 after f32 sums taken in another order on each
    side, so at this size a few land one bf16 ulp apart and move a logit
    by ~1e-4 (measured 1.3e-4 on the slots, 2.4e-4 on the mask): the bound
    is chip_smoke.py's slot-attention tolerance, 2e-3, stated there for
    this same mechanism."""
    B, N, S, D, M, iters = 2, 1024, 15, 192, 384, 2
    p = _sa_weights(D, M, seed=3, std=D ** -0.5)
    r = np.random.RandomState(4)
    k, v = (r.randn(B, N, D).astype(np.float32) for _ in range(2))
    slots = r.randn(B, S, D).astype(np.float32)
    args = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots),
            {key: jnp.asarray(val) for key, val in p.items()})
    kw = dict(num_iterations=iters, eps=1e-6, return_last_attn=True)
    if kv == "float32":
        ref, ref_mask = jax_sa_ref(*args, **kw)
        tol = F32_TOL
    else:
        ref, ref_mask = sa_iterations_pallas(
            *args, interpret=True, kv_dtype=jnp.bfloat16, **kw)
        tol = dict(rtol=1e-4, atol=2e-3)
    out, mask = slot_attention_kernel.sa_iterations_ref(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(slots),
        {key: torch.from_numpy(p[key]) for key in SA_WEIGHT_KEYS},
        kv_dtype=getattr(torch, kv), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref_mask), **tol)


@pytest.mark.parametrize("N,S,D,M", [(1024, 15, 192, 384),  # flagship
                                     (1000, 7, 64, 128),    # ragged edge
                                     (1001, 16, 256, 1024)])  # the limits
@pytest.mark.parametrize("B", [1, 2, 12, 32])
def test_launch_plan_splits_every_item_over_one_cluster(B, N, S, D, M):
    """The slot-attention kernel's plan, as the wrapper passes it to the C
    entry point: a cluster size the card takes (1-16, a power of two);
    every position owned by exactly one block of the cluster; resident
    k/v only when one tile holds the block's positions; shared memory
    within the H100's 232,448 bytes a block; all B clusters at once on the
    card, with the flagship's sizes at serving (B = 2) and training
    (B = 32) as the kernel's note states them."""
    plan = slot_attention_kernel.launch_plan(B, N, S, D, M)
    C, P, tile = plan["cluster"], plan["positions"], plan["tile"]
    assert C in (1, 2, 4, 8, 16)
    assert B <= slot_attention_kernel.ACTIVE_CLUSTERS[C] or C == 1
    owners = np.zeros(N, dtype=int)
    for rank in range(C):
        owners[min(N, rank * P):min(N, (rank + 1) * P)] += 1
    assert (owners == 1).all()
    assert tile % 16 == 0 and tile >= 16
    assert not plan["resident"] or tile >= P
    assert plan["smem_bytes"] == slot_attention_kernel.smem_bytes(
        D, M, C, tile, plan["resident"]) <= 232448
    if (N, D) == (1024, 192):
        assert C == {1: 16, 2: 16, 12: 8, 32: 2}[B]
        assert plan["resident"] == (B != 32)


def test_launch_plan_refuses_what_the_kernel_does_not_take():
    for args in ((0, 10, 4, 8, 8), (2, 0, 4, 8, 8), (2, 10, 17, 8, 8),
                 (2, 10, 4, 7, 8), (2, 10, 4, 258, 8), (2, 10, 4, 8, 1025)):
        with pytest.raises(ValueError):
            slot_attention_kernel.launch_plan(*args)


def test_c_entry_points_match_their_declared_signatures():
    """Every `extern "C"` entry point of csrc/*.cu has a ctypes signature
    in `_cuda._SIGNATURES` with one argtype per parameter, of the right
    kind (pointer, int, float): ctypes would otherwise pass the kernels
    misaligned arguments on the card, where nothing checks them."""
    import glob
    import os
    import re
    from slotdiffusion_tpu_torch.ops import _cuda
    kinds = {_cuda._P: "pointer", _cuda._I: "int", _cuda._F: "float"}
    found = {}
    for path in glob.glob(os.path.join(_cuda.CSRC, "*.cu")):
        text = open(path).read()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = [
                "pointer" if "*" in p else p.split()[-2]
                if len(p.split()) > 1 else p for p in params.split(",")]
    assert set(found) == set(_cuda._SIGNATURES)
    for name, params in found.items():
        assert params == [kinds[t] for t in _cuda._SIGNATURES[name]], name


def test_group_norm_is_cuda_and_the_port_never_imports_triton():
    """GN is a CUDA C++ kernel built by `_cuda` like the others (its source
    under csrc/, its entry point declared), and importing every module of
    the port, then running a GN layer on the CPU, loads no `triton`."""
    import os
    import subprocess
    import sys
    from slotdiffusion_tpu_torch.ops import _cuda
    assert fused_norm.ROUTE == "cuda"
    assert fused_norm.SOURCE.startswith("slotdiffusion_tpu_torch/csrc/")
    assert os.path.exists(os.path.join(_cuda.CSRC, os.path.basename(
        fused_norm.SOURCE)))
    assert "sdt_group_norm_f32" in _cuda._SIGNATURES
    code = ("import pkgutil, sys, torch, slotdiffusion_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "
            "'.'):\n"
            "    __import__(m.name)\n"
            "from slotdiffusion_tpu_torch.models.blocks import GroupNorm32\n"
            "GroupNorm32(64, act='silu', fused=True)(torch.ones(2, 64, 4, "
            "4))\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == "
            "'triton'], 'triton imported'\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True,
                   timeout=120, env=dict(os.environ, OMP_NUM_THREADS=str(
                       torch.get_num_threads())))


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
    x = torch.empty(1, 4, 4, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        winograd_conv3x3(x, torch.empty(3, 3, 16, 16, device="meta"))
    # the bf16 entry points' inputs, and a dtype no entry point takes
    for dtype in (torch.bfloat16, torch.float16):
        x = torch.empty(1, 32, 4, 4, device="meta", dtype=dtype)
        with pytest.raises(ValueError):
            fused_group_norm(x, w, w, 32)
        q = torch.empty(1, 16, 64, device="meta", dtype=dtype)
        with pytest.raises(ValueError):
            fused_mha(q, q, q, 2)
    # the CPU path is the plain version and launches nothing
    fused_group_norm(torch.ones(1, 32, 4, 4), torch.ones(32),
                     torch.zeros(32), 32)
    fused_group_norm(torch.ones(1, 32, 4, 4, dtype=torch.bfloat16),
                     torch.ones(32), torch.zeros(32), 32)
    winograd_conv3x3(torch.ones(1, 4, 4, 16), torch.ones(3, 3, 16, 16))
    assert ops.launch_counts() == {
        "gn_silu": 0, "attention": 0, "slot_attention": 0,
        "winograd_conv3x3": 0, "gn_silu_bf16": 0, "attention_bf16": 0}


# ---- the fourth kernel: Winograd F(2x2, 3x3) ----------------------------

# one bf16 ulp at the output's largest magnitude: U and V are rounded to
# bf16 at the same points on both sides, so only an f32 sum taken in
# another order, or a U entry whose f32 einsum lands on the other side of
# a bf16 rounding boundary, differs
def _bf16_ulp_tol(ref):
    return 2.0 ** -7 * float(np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,f", [((2, 8, 8, 128), 128),
                                     ((1, 4, 6, 128), 128)])
def test_winograd_matches_pallas(dtype, shape, f):
    """The plain version and the CPU path of `winograd_conv3x3` against the
    JAX Pallas kernel in interpret mode, the same input dtype on both
    sides (the shapes of the JAX package's tests/test_winograd.py)."""
    r = np.random.RandomState(3)
    x = r.randn(*shape).astype(np.float32)
    w = (r.randn(3, 3, shape[-1], f) * 0.05).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = np.asarray(jax_winograd(jx, jnp.asarray(w), True)).astype(
        np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for out in (winograd_reference(tx, torch.from_numpy(w)),
                winograd_conv3x3(tx, torch.from_numpy(w))):
        assert out.dtype == tx.dtype and out.shape == (*shape[:3], f)
        err = np.abs(out.float().numpy() - ref).max()
        assert err <= _bf16_ulp_tol(ref), (err, _bf16_ulp_tol(ref))


@pytest.mark.parametrize("shape,f", [((2, 8, 8, 128), 128),
                                     ((1, 6, 10, 72), 40)])
def test_winograd_split_matches_jax_weights_and_conv(shape, f):
    """The two halves of the entry point, as the JAX package splits them:
    `kernel_weights` (U^T, zero-padded to the kernel's blocks) holds the
    JAX `winograd_weights(w)` in bf16 bit for bit, and the convolution on
    U (`winograd_conv3x3_u`, the plain version on the CPU) the JAX Pallas
    kernel on the same U in interpret mode, to one bf16 ulp; on U it is
    `winograd_conv3x3` exactly."""
    r = np.random.RandomState(5)
    x = r.randn(*shape).astype(np.float32)
    w = (r.randn(3, 3, shape[-1], f) * 0.05).astype(np.float32)
    ju = jax_winograd_weights(jnp.asarray(w)).astype(jnp.bfloat16)
    ut = winograd_conv.kernel_weights(torch.from_numpy(w))
    Fp, Cp = ut.shape[1:]
    assert ut.dtype == torch.bfloat16 and Fp % winograd_conv.TILE_N == 0 \
        and Cp % winograd_conv.TILE_K == 0
    assert not ut[:, f:].any() and not ut[:, :, shape[-1]:].any()
    np.testing.assert_array_equal(
        ut[:, :f, :shape[-1]].transpose(1, 2).float().numpy(),
        np.asarray(ju.astype(jnp.float32)))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    y = winograd_conv.winograd_conv3x3_u(tx, ut, f)
    assert torch.equal(y, winograd_conv3x3(tx, torch.from_numpy(w)))
    if shape[-1] % 128 == 0:  # the shapes the JAX kernel takes
        ref = np.asarray(jax_wino_call(jnp.asarray(x).astype(jnp.bfloat16),
                                       ju, f, interpret=True)).astype(
            np.float32)
        err = np.abs(y.float().numpy() - ref).max()
        assert err <= _bf16_ulp_tol(ref), (err, _bf16_ulp_tol(ref))


@pytest.mark.parametrize("shape", [(2, 6, 10, 16), (1, 5, 7, 8)])
def test_winograd_reference_matches_direct_conv(shape):
    """Any H and W (odd edges included) against the f32 direct conv, to
    the JAX tests' bf16-class bound."""
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.randn(*shape).astype(np.float32))
    w = torch.from_numpy((r.randn(3, 3, shape[-1], 12) * 0.2).astype(
        np.float32))
    y = winograd_reference(x, w)
    ref = direct_conv(x, w)
    assert (y - ref).abs().max() <= 3e-2 * ref.abs().max()


# ---- each autograd.Function's CPU path against jax.grad ------------------

def _proj(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _torch_grads(fn, arrays, proj):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    out = out[0] if isinstance(out, tuple) else out
    (out * torch.from_numpy(proj)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _assert_grads_close(got, want, rtol, atol_of_scale):
    """atol is `atol_of_scale` of each leaf's largest magnitude, or of a
    hundredth of the largest leaf's where that is larger: a leaf whose
    gradient is zero in exact arithmetic holds f32 noise (the q-LN bias of
    slot attention: it shifts every slot's logit at a position alike, and
    the softmax over the slots ignores that)."""
    want = [np.asarray(w) for w in want]
    floor = 1e-2 * max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_of_scale * max(np.abs(w).max(),
                                                      floor))


@pytest.mark.parametrize("act,eps", [(None, 1e-6), ("silu", 1e-5)])
def test_group_norm_grad_matches_jax(act, eps):
    r = np.random.RandomState(5)
    x = (r.randn(2, 4, 4, 128) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * r.randn(128)).astype(np.float32)
    b = (0.1 * r.randn(128)).astype(np.float32)
    proj = _proj(x.shape, 6)
    want = jax.grad(lambda *a: jnp.sum(jax_gn(*a, 32, eps, act, True) *
                                       proj), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = _torch_grads(
        lambda x, w, b: fused_group_norm(
            x.permute(0, 3, 1, 2), w, b, 32, eps, act).permute(0, 2, 3, 1),
        [x, w, b], proj)
    _assert_grads_close(got, want, 1e-4, 1e-5)


@pytest.mark.parametrize("nq,nk,hd,heads", [(64, 64, 256, 8),
                                            (16, 15, 256, 8)])
def test_attention_grad_matches_jax(nq, nk, hd, heads):
    r = np.random.RandomState(7)
    q, k, v = (r.randn(2, n, hd).astype(np.float32) for n in (nq, nk, nk))
    proj = _proj(q.shape, 8)
    want = jax.grad(lambda *a: jnp.sum(jax_mha(*a, heads, None, True) *
                                       proj), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _torch_grads(lambda q, k, v: fused_mha(q, k, v, heads),
                       [q, k, v], proj)
    _assert_grads_close(got, want, 1e-4, 1e-5)


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
def test_slot_attention_grad_matches_jax(kv):
    """The JAX custom_vjp differentiates the f32 jnp twin at the f32 k/v
    (`_sa_bwd`), whatever type the forward streams k/v in; so must the
    port, also with the flagship's bf16 k/v."""
    B, N, S, D, iters = 2, 64, 5, 32, 2
    p = _sa_weights(D, 2 * D, seed=1)
    r = np.random.RandomState(9)
    k, v = (r.randn(B, N, D).astype(np.float32) for _ in range(2))
    slots = r.randn(B, S, D).astype(np.float32)
    proj = _proj(slots.shape, 10)
    arrays = [k, v, slots] + [p[key] for key in SA_WEIGHT_KEYS]

    def jloss(k, v, slots, *w):
        out = jax_sa_ref(k, v, slots, dict(zip(SA_WEIGHT_KEYS, w)),
                         num_iterations=iters, eps=1e-6,
                         return_last_attn=True)[0]
        return jnp.sum(out * proj)

    want = jax.grad(jloss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    got = _torch_grads(
        lambda k, v, slots, *w: sa_iterations(
            k, v, slots, dict(zip(SA_WEIGHT_KEYS, w)),
            num_iterations=iters, eps=1e-6, return_last_attn=True,
            kv_dtype=getattr(torch, kv)), arrays, proj)
    _assert_grads_close(got, want, 1e-4, 1e-5)


def test_winograd_grad_matches_jax():
    r = np.random.RandomState(11)
    x = r.randn(1, 4, 6, 128).astype(np.float32)
    w = (r.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
    proj = _proj((1, 4, 6, 128), 12)
    want = jax.grad(lambda x, w: jnp.sum(jax_winograd(x, w, True) * proj),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    got = _torch_grads(winograd_conv3x3, [x, w], proj)
    _assert_grads_close(got, want, 1e-4, 1e-5)


def _gn_case(r):
    x = torch.from_numpy(r.randn(2, 64, 4, 4).astype(np.float32))
    w, b = (torch.from_numpy(r.randn(64).astype(np.float32))
            for _ in range(2))
    return fused_norm, [x, w, b], (8, 1e-5, "silu"), \
        lambda *a: fused_norm.group_norm_reference(*a, 8, 1e-5, "silu")


def _mha_case(r):
    q, k, v = (torch.from_numpy(r.randn(2, n, 64).astype(np.float32))
               for n in (16, 15, 15))
    return attention_kernel, [q, k, v], (2, None), \
        lambda *a: attention_kernel.mha_reference(*a, 2)


def _sa_case(r):
    p = _sa_weights(16, 32, seed=2)
    t = [torch.from_numpy(r.randn(*s).astype(np.float32))
         for s in ((2, 24, 16), (2, 24, 16), (2, 4, 16))]
    t += [torch.from_numpy(p[key]) for key in SA_WEIGHT_KEYS]

    def plain(k, v, s, *w):
        return slot_attention_kernel.sa_iterations_ref(
            k, v, s, dict(zip(SA_WEIGHT_KEYS, w)), num_iterations=2,
            eps=1e-6, kv_dtype=torch.float32)
    return slot_attention_kernel, t, (2, 1e-6, False, torch.float32), plain


def _wino_case(r):
    x = torch.from_numpy(r.randn(1, 4, 4, 16).astype(np.float32))
    w = torch.from_numpy(r.randn(3, 3, 16, 8).astype(np.float32) * 0.1)
    return winograd_conv, [x, w], (), winograd_conv.direct_conv


@pytest.mark.parametrize("case", [_gn_case, _mha_case, _sa_case,
                                  _wino_case])
def test_backward_does_not_need_the_forward_graph(case, monkeypatch):
    """On the card a kernel writes its output through a raw pointer, so
    the output has no autograd graph of its own. Each Function's backward
    must give the plain version's gradients all the same: here the forward
    is replaced by its plain version with the graph cut off."""
    mod, inputs, args, plain = case(np.random.RandomState(13))
    fn = {fused_norm: fused_group_norm, attention_kernel: fused_mha,
          winograd_conv: winograd_conv3x3}.get(mod)
    if mod is slot_attention_kernel:
        def fn(k, v, s, *w):
            return sa_iterations(k, v, s, dict(zip(SA_WEIGHT_KEYS, w)),
                                 num_iterations=2, eps=1e-6,
                                 kv_dtype=torch.float32)
        args = ()
    real = mod._forward
    monkeypatch.setattr(mod, "_forward",
                        lambda *a: real(*a).detach())
    got = [t.clone().requires_grad_() for t in inputs]
    want = [t.clone().requires_grad_() for t in inputs]
    out = fn(*got, *args)
    assert out.grad_fn is not None
    proj = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    (out * proj).sum().backward()
    (plain(*want) * proj).sum().backward()
    for g, w in zip(got, want):
        assert g.grad is not None and g.grad.abs().max() > 0
        torch.testing.assert_close(g.grad, w.grad, rtol=1e-5, atol=1e-6)
