"""Multi-head attention with the clamped-exp softmax: a CUDA kernel
(`csrc/attention.cu`) and its plain version.

Replaces the Pallas kernel `_mha_kernel` driven by `fused_mha`
(the JAX package's ops/attention_kernel.py:61-90, 119-156). Heads are
packed: q [B, Nq, H*D], k/v [B, Nk, H*D] -> [B, Nq, H*D]. The softmax is
`exp(min(logits, 80)) / (sum + 1e-30)` without max subtraction, so the
kernel is one pass over the keys with no rescaling (see the source for
the design and its bound on the H100). The UNet reaches it through
`attn_backend="fused"`, which ignores `attn_softmax` as the JAX package
does.

Two entry points: `sdt_mha_f32` and `sdt_mha_bf16` (bf16 q/k/v/out, f32
logits and sums; `wgmma` and TMA on Hopper). Under bf16 both the kernel
and `mha_reference` round at the JAX kernel's point: the normalized
weights to bf16 before the value product (the JAX package's
ops/attention_kernel.py:57, 81-83), whose sums are f32, then the output;
past 256 keys the kernel rounds the unnormalized weights and divides
once at the end, one bf16 rounding a weight either way. The wrapper
takes the entry of q's dtype and raises on any other dtype.

The forward is also the PyTorch operator `sdt::mha` (CPU: the plain
version; CUDA: the same ctypes launch; fake: q's shape and dtype), which
only a call made while exporting goes through (`_forward`): eager calls
skip the dispatcher. The autograd.Function is entered only when a
gradient can flow.
"""

from typing import Optional

import torch

from . import _cuda

KERNEL_NAME = "attention"
ROUTE = "cuda"
SOURCE = "slotdiffusion_tpu_torch/csrc/attention.cu"
REPLACES = "ops/attention_kernel.py:61"  # in the JAX package
HEAD_DIM = 32  # the only head width the kernel takes (the UNet's)

ENTRY = {torch.float32: "sdt_mha_f32", torch.bfloat16: "sdt_mha_bf16"}
# kernel launches since ops.reset_launch_counts(), by entry point
launches = dict.fromkeys(ENTRY.values(), 0)


def mha_reference(q, k, v, num_heads, scale=None):
    """Plain version: clamped-exp multi-head attention with f32 logits and
    sums; the weights rounded to q's dtype before the value product, the
    output to q's dtype. The CPU path of `fused_mha`."""
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    D = HD // num_heads
    scale = D ** -0.5 if scale is None else scale
    qh = q.float().reshape(B, Nq, num_heads, D).transpose(1, 2)
    kh = k.float().reshape(B, Nk, num_heads, D).transpose(1, 2)
    vh = v.float().reshape(B, Nk, num_heads, D).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) * scale
    e = torch.exp(torch.clamp(logits, max=80.0))
    w = (e / (e.sum(-1, keepdim=True) + 1e-30)).to(q.dtype).float()
    out = (w @ vh).transpose(1, 2).reshape(B, Nq, HD)
    return out.to(q.dtype)


def check_inputs(q, k, v, num_heads):
    """Raise ValueError unless the kernel takes these arguments: contiguous
    q [B, Nq, H*32] and k = v [B, Nk, H*32] of one dtype, f32 or bf16, on
    one device, each 16-byte aligned (the f32 entry stages K and V with
    16-byte loads; the bf16 entry's TMA maps need 16-byte-aligned
    rows)."""
    if q.dim() != 3 or k.dim() != 3 or k.shape[0] != q.shape[0] or \
            k.shape[2] != q.shape[2] or v.shape != k.shape:
        raise ValueError(f"fused_mha: q {tuple(q.shape)} k {tuple(k.shape)}"
                         f" v {tuple(v.shape)} do not match")
    if q.shape[2] != num_heads * HEAD_DIM:
        raise ValueError(f"fused_mha takes head_dim {HEAD_DIM}, got "
                         f"{q.shape[2]} / {num_heads}")
    for t in (q, k, v):
        if t.dtype not in ENTRY or t.dtype != q.dtype or \
                not t.is_contiguous() or t.device != q.device or \
                t.data_ptr() % 16:
            raise ValueError("fused_mha takes contiguous, 16-byte-aligned "
                             "f32 or bf16 tensors of one dtype on one "
                             "device")


@_cuda.traced("sdt::mha")
def _launch(q, k, v, num_heads, scale):
    """The CUDA kernel on CUDA q, k, v."""
    check_inputs(q, k, v, num_heads)
    B, Nq, _ = q.shape
    scale = HEAD_DIM ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    entry = ENTRY[q.dtype]
    err = getattr(_cuda.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Nq,
        k.shape[1], num_heads, HEAD_DIM, float(scale),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, entry)
    launches[entry] += 1
    return out


@torch.library.custom_op("sdt::mha", mutates_args=(), device_types="cpu")
def mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
           scale: Optional[float]) -> torch.Tensor:
    """Clamped-exp attention as an operator: on the CPU the plain
    version."""
    return mha_reference(q, k, v, num_heads, scale)


@mha_op.register_kernel("cuda")
def _(q, k, v, num_heads, scale):
    return _launch(q, k, v, num_heads, scale)


@mha_op.register_fake
def _(q, k, v, num_heads, scale):
    return torch.empty_like(q)


def _forward(q, k, v, num_heads, scale):
    if torch.compiler.is_exporting():
        return mha_op(q, k, v, num_heads, scale)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha: unsupported device {q.device}")
    return _launch(q, k, v, num_heads, scale)


class FusedMHA(torch.autograd.Function):
    """Forward: the CUDA kernel (CUDA) or the plain version (CPU).
    Backward: autograd of the clamped-exp `mha_reference` recomputed at the
    saved (q, k, v), as the JAX custom_vjp's `_fused_mha_bwd`
    (ops/attention_kernel.py:118-174 of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (num_heads, scale)
        return _forward(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = mha_reference(*inputs, *ctx.args)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None)


def fused_mha(q, k, v, num_heads, scale=None):
    """Clamped-exp attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; differentiable through `FusedMHA` (entered
    only when a gradient can flow)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return FusedMHA.apply(q, k, v, num_heads, scale)
    return _forward(q, k, v, num_heads, scale)
