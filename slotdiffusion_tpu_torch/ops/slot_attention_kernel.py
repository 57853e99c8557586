"""All slot-attention iterations in one CUDA kernel
(`csrc/slot_attention.cu`, one thread-block cluster per item) and its
plain version.

Replaces the Pallas kernels `_sa_kernel_resident` / `_sa_kernel` driven by
`sa_iterations_pallas` (the JAX package's ops/slot_attention_kernel.py:
134-250, 267-316, 319-416). Per iteration: q = LN(slots) @ Wq, a softmax
over the slots at each position, the last-iteration mask, the
eps-renormalized weighted mean of v folded as
`(num + eps * vsum) / (den + N * eps)`, a torch-parameterized GRUCell and
the LN-MLP residual. k/v are held in `kv_dtype` (bf16 by default, as the
JAX kernel streams them); q and the attention weights are rounded to that
type before their products, and every product accumulates in f32.

The weight dict has the JAX kernel's keys and layout (`SA_WEIGHT_KEYS`,
`x @ W` orientation, GRU gates packed r | z | n). `launch_plan` decides
how the kernel splits an item over a cluster; the wrapper passes the plan
to the C entry point, which refuses a plan it cannot run.

The forward is also the PyTorch operator `sdt::sa_iterations` (CPU: the
plain version; CUDA: the same ctypes launch; fake: the slots' and the
mask's shapes, f32), which only a call made while exporting goes through
(`_forward`): eager calls skip the dispatcher. It returns the mask always,
empty unless `return_last_attn`. The autograd.Function is entered only
when a gradient can flow.
"""

import ctypes
from typing import List

import torch

from . import _cuda

KERNEL_NAME = "slot_attention"
ROUTE = "cuda"
SOURCE = "slotdiffusion_tpu_torch/csrc/slot_attention.cu"
REPLACES = "ops/slot_attention_kernel.py:134"  # in the JAX package
MAX_SLOTS, MAX_D, MAX_M = 16, 256, 1024  # what one cluster holds
# the H100 (SXM): shared memory a block may use, and how many clusters of
# each size (one block an SM) it runs at once: cudaOccupancyMaxActiveClusters
# on an NVIDIA H100 80GB HBM3 (700 W), the same from 100 KB to 218 KB a
# block (chip_smoke.py prints it beside each plan). 16 is a non-portable
# cluster size.
SMEM_LIMIT = 232448
ACTIVE_CLUSTERS = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}
CLUSTER_SIZES = (16, 8, 4, 2, 1)
STREAM_TILES = (64, 32, 16)  # positions a streamed tile (two buffers)

SA_WEIGHT_KEYS = ("wq", "ln_q_scale", "ln_q_bias", "gru_wi", "gru_bi",
                  "gru_wh", "gru_bh", "ln_mlp_scale", "ln_mlp_bias",
                  "w1", "b1", "w2", "b2")
# torch nn.LayerNorm default eps, as the JAX kernel uses
_LN_EPS = 1e-5

ENTRY = "sdt_sa_iterations_bf16"
# kernel launches since ops.reset_launch_counts(), by entry point
launches = {ENTRY: 0}


def _ln(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * scale + bias


def _gru(h, x, wi, bi, wh, bh):
    D = h.shape[-1]
    gi = x @ wi + bi
    gh = h @ wh + bh
    r = torch.sigmoid(gi[..., :D] + gh[..., :D])
    z = torch.sigmoid(gi[..., D:2 * D] + gh[..., D:2 * D])
    n = torch.tanh(gi[..., 2 * D:] + r * gh[..., 2 * D:])
    return (1.0 - z) * n + z * h


def sa_iterations_ref(k, v, slots, p, *, num_iterations, eps,
                      return_last_attn=False, kv_dtype=torch.bfloat16):
    """Plain version of the kernel; the CPU path of `sa_iterations`.

    k, v [B, N, D]; slots [B, S, D]; p: SA_WEIGHT_KEYS dict.
    Returns slots [B, S, D] (and the last-iteration attention [B, S, N]
    before the renormalization when `return_last_attn`)."""
    rnd = lambda t: t.to(kv_dtype).float()
    k, v = rnd(k), rnd(v)
    slots = slots.float()
    p = {key: p[key].float() for key in SA_WEIGHT_KEYS}
    N, D = k.shape[1], k.shape[2]
    scale = D ** -0.5
    vsum = v.sum(1, keepdim=True)  # [B, 1, D]
    mask = None
    for it in range(num_iterations):
        q = rnd(_ln(slots, p["ln_q_scale"], p["ln_q_bias"]) @ p["wq"])
        logits = scale * (q @ k.transpose(1, 2))  # [B, S, N]
        a = torch.softmax(logits, dim=1)          # over the slots
        if it == num_iterations - 1 and return_last_attn:
            mask = a
        num = rnd(a) @ v                           # [B, S, D]
        den = a.sum(-1, keepdim=True)              # [B, S, 1]
        updates = (num + eps * vsum) / (den + N * eps)
        new = _gru(slots, updates, p["gru_wi"], p["gru_bi"], p["gru_wh"],
                   p["gru_bh"])
        h = torch.relu(_ln(new, p["ln_mlp_scale"], p["ln_mlp_bias"]) @
                       p["w1"] + p["b1"])
        slots = new + (h @ p["w2"] + p["b2"])
    if return_last_attn:
        return slots, mask
    return slots


def _round_up(x, m):
    return -(-x // m) * m


def smem_bytes(D, M, cluster, tile, resident):
    """Shared memory of one block of the kernel: `make_layout` in
    csrc/slot_attention.cu, region by region (each rounded to 16 bytes)."""
    Dp = _round_up(D, 16)
    LD, KLD = Dp + 4, Dp + 8
    MLD = _round_up(M, 8) + 4
    CW = _round_up(-(-D // cluster), 4)
    HW = _round_up(-(-M // cluster), 4)
    buffers = 1 if resident else 2
    warps, slots, mats = 8, MAX_SLOTS, 6
    f32 = [slots * LD] * 3 + [
        slots * MLD, cluster * slots * CW, cluster * slots, cluster * CW,
        warps * mats * 128, warps * slots, slots, CW, 4 * D + 8 * CW + HW]
    bf16 = [slots * KLD, buffers * 2 * tile * KLD, slots * (tile + 8)]
    return sum(_round_up(4 * n, 16) for n in f32) + \
        sum(_round_up(2 * n, 16) for n in bf16)


def launch_plan(B, N, S, D, M):
    """How the kernel runs B items of N positions: one cluster of
    `cluster` blocks per item, block r owning positions
    [r * positions, (r + 1) * positions). The size is the largest of
    CLUSTER_SIZES whose B clusters the card runs at once (ACTIVE_CLUSTERS:
    16 at B <= 7, 8 at B <= 15, 4 at B <= 30, 2 at B <= 66, then 1): a
    second wave of clusters costs more than halving the blocks, which
    doubles each block's share of the slot update. The block's k/v rows
    stay in shared memory across the iterations (`resident`, one tile)
    where they fit, else they are streamed in double-buffered tiles of the
    first of STREAM_TILES positions that fits. -> dict(cluster, positions,
    tile, resident, smem_bytes)."""
    if not (B >= 1 and N >= 1 and 1 <= S <= MAX_SLOTS and 2 <= D <= MAX_D
            and D % 2 == 0 and 1 <= M <= MAX_M):
        raise ValueError(f"launch_plan: B={B} N={N} S={S} D={D} M={M} "
                         "outside the kernel's range")
    cluster = next(c for c in CLUSTER_SIZES
                   if B <= ACTIVE_CLUSTERS[c] or c == 1)
    positions = -(-N // cluster)
    tile = _round_up(positions, 16)
    resident = smem_bytes(D, M, cluster, tile, True) <= SMEM_LIMIT
    if not resident:
        tile = next(t for t in STREAM_TILES
                    if smem_bytes(D, M, cluster, t, False) <= SMEM_LIMIT)
    return dict(cluster=cluster, positions=positions, tile=tile,
                resident=resident,
                smem_bytes=smem_bytes(D, M, cluster, tile, resident))


def active_clusters(plan):
    """How many clusters of `plan` the card runs at once (the CUDA
    occupancy API, on the current card)."""
    out = ctypes.c_int(0)
    _cuda.check(_cuda.lib().sdt_sa_active_clusters(
        plan["cluster"], plan["smem_bytes"], ctypes.byref(out)),
        "sdt_sa_active_clusters")
    return out.value


def check_inputs(k, v, slots, p, num_iterations, kv_dtype):
    """Raise ValueError unless the kernel takes these arguments: bf16 k/v
    streaming, k = v [B, N, D], slots [B, S <= 16, D], D <= 256 and even,
    M <= 1024, f32 weights of SA_WEIGHT_KEYS shapes on k's device."""
    if kv_dtype != torch.bfloat16:
        raise ValueError("the slot-attention kernel streams k/v in bf16 "
                         f"only, got kv_dtype={kv_dtype}")
    B, N, D = k.shape
    S = slots.shape[1]
    M = p["w1"].shape[1]
    if v.shape != k.shape or slots.shape != (B, S, D):
        raise ValueError(f"sa_iterations: k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} slots {tuple(slots.shape)}")
    if S > MAX_SLOTS or D > MAX_D or D % 2 or M > MAX_M or \
            num_iterations < 1:
        raise ValueError(f"sa_iterations: S={S} D={D} M={M} iters="
                         f"{num_iterations} outside the kernel's range")
    expect = {"wq": (D, D), "ln_q_scale": (D,), "ln_q_bias": (D,),
              "gru_wi": (D, 3 * D), "gru_bi": (3 * D,),
              "gru_wh": (D, 3 * D), "gru_bh": (3 * D,),
              "ln_mlp_scale": (D,), "ln_mlp_bias": (D,), "w1": (D, M),
              "b1": (M,), "w2": (M, D), "b2": (D,)}
    for key in SA_WEIGHT_KEYS:
        t = p[key]
        if tuple(t.shape) != expect[key] or t.dtype != torch.float32 or \
                t.device != k.device:
            raise ValueError(f"sa_iterations: weight {key} must be f32 "
                             f"{expect[key]} on {k.device}")


@_cuda.traced("sdt::sa_iterations")
def _launch(k, v, slots, p, num_iterations, eps, return_last_attn,
            kv_dtype):
    """The CUDA kernel on CUDA tensors."""
    check_inputs(k, v, slots, p, num_iterations, kv_dtype)
    B, N, D = k.shape
    S = slots.shape[1]
    M = p["w1"].shape[1]
    w = [p[key].contiguous() for key in SA_WEIGHT_KEYS]
    kb = k.to(torch.bfloat16).contiguous()
    vb = v.to(torch.bfloat16).contiguous()
    s0 = slots.float().contiguous()
    out = torch.empty_like(s0)
    mask = torch.empty((B, S, N), dtype=torch.float32, device=k.device) \
        if return_last_attn else out  # unused when with_mask = 0
    plan = launch_plan(B, N, S, D, M)
    err = getattr(_cuda.lib(), ENTRY)(
        kb.data_ptr(), vb.data_ptr(), s0.data_ptr(),
        *[t.data_ptr() for t in w], out.data_ptr(), mask.data_ptr(),
        B, N, S, D, M, num_iterations, float(eps), float(D ** -0.5),
        int(return_last_attn), plan["cluster"], plan["positions"],
        plan["tile"], int(plan["resident"]), plan["smem_bytes"],
        _cuda.stream_ptr(k.device))
    _cuda.check(err, ENTRY)
    launches[ENTRY] += 1
    if return_last_attn:
        return out, mask
    return out


def _op_outputs(out, return_last_attn):
    """(slots, mask) of the operator: the mask empty unless asked for."""
    if return_last_attn:
        return out
    return out, out.new_empty((0,))


@torch.library.custom_op("sdt::sa_iterations", mutates_args=(),
                         device_types="cpu")
def sa_iterations_op(k: torch.Tensor, v: torch.Tensor, slots: torch.Tensor,
                     weights: List[torch.Tensor], num_iterations: int,
                     eps: float, return_last_attn: bool,
                     kv_dtype: torch.dtype
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """All slot-attention iterations as an operator: on the CPU the plain
    version. `weights` in SA_WEIGHT_KEYS order."""
    out = sa_iterations_ref(
        k, v, slots, dict(zip(SA_WEIGHT_KEYS, weights)),
        num_iterations=num_iterations, eps=eps,
        return_last_attn=return_last_attn, kv_dtype=kv_dtype)
    return _op_outputs(out, return_last_attn)


@sa_iterations_op.register_kernel("cuda")
def _(k, v, slots, weights, num_iterations, eps, return_last_attn, kv_dtype):
    out = _launch(k, v, slots, dict(zip(SA_WEIGHT_KEYS, weights)),
                  num_iterations, eps, return_last_attn, kv_dtype)
    return _op_outputs(out, return_last_attn)


@sa_iterations_op.register_fake
def _(k, v, slots, weights, num_iterations, eps, return_last_attn, kv_dtype):
    B, S = slots.shape[:2]
    f32 = torch.float32
    mask = (B, S, k.shape[1]) if return_last_attn else (0,)
    return slots.new_empty(slots.shape, dtype=f32), \
        slots.new_empty(mask, dtype=f32)


def _forward(k, v, slots, p, num_iterations, eps, return_last_attn,
             kv_dtype):
    if torch.compiler.is_exporting():
        out, mask = sa_iterations_op(
            k, v, slots, [p[key] for key in SA_WEIGHT_KEYS], num_iterations,
            eps, return_last_attn, kv_dtype)
        return (out, mask) if return_last_attn else out
    if k.device.type == "cpu":
        return sa_iterations_ref(
            k, v, slots, p, num_iterations=num_iterations, eps=eps,
            return_last_attn=return_last_attn, kv_dtype=kv_dtype)
    return _launch(k, v, slots, p, num_iterations, eps, return_last_attn,
                   kv_dtype)


class SlotAttentionIterations(torch.autograd.Function):
    """Forward: the CUDA kernel with bf16 k/v (CUDA) or the plain version
    in `kv_dtype` (CPU). Backward: autograd of `sa_iterations_ref` in f32
    (`kv_dtype=torch.float32`) at the saved f32 (k, v, slots, weights), as
    the JAX custom_vjp's `_sa_bwd` differentiates its f32 jnp twin
    (ops/slot_attention_kernel.py:419-450 of the JAX package). The mask
    carries no gradient (the JAX kernel's `stop_gradient`). The weights
    come after the other arguments, in SA_WEIGHT_KEYS order."""

    @staticmethod
    def forward(ctx, k, v, slots, num_iterations, eps, return_last_attn,
                kv_dtype, *weights):
        ctx.save_for_backward(k, v, slots, *weights)
        ctx.args = (num_iterations, eps)
        out = _forward(k, v, slots, dict(zip(SA_WEIGHT_KEYS, weights)),
                       num_iterations, eps, return_last_attn, kv_dtype)
        if return_last_attn:
            ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, g_slots, *g_mask):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        num_iterations, eps = ctx.args
        with torch.enable_grad():
            out = sa_iterations_ref(
                *inputs[:3], dict(zip(SA_WEIGHT_KEYS, inputs[3:])),
                num_iterations=num_iterations, eps=eps,
                kv_dtype=torch.float32)
            grads = torch.autograd.grad(out, inputs, g_slots)
        return (*grads[:3], None, None, None, None, *grads[3:])


def sa_iterations(k, v, slots, p, *, num_iterations, eps,
                  return_last_attn=False, kv_dtype=torch.bfloat16):
    """Slot-attention refinement: the CUDA kernel for CUDA tensors (bf16
    k/v only), the plain version for CPU tensors; differentiable through
    `SlotAttentionIterations` (entered only when a gradient can flow)."""
    if k.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sa_iterations: unsupported device {k.device}")
    weights = [p[key] for key in SA_WEIGHT_KEYS]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (k, v, slots, *weights)):
        return SlotAttentionIterations.apply(
            k, v, slots, num_iterations, eps, return_last_attn, kv_dtype,
            *weights)
    return _forward(k, v, slots, p, num_iterations, eps, return_last_attn,
                    kv_dtype)
