"""GroupNorm(+SiLU) in one pass: a CUDA kernel (`csrc/group_norm.cu`)
and its plain version.

Replaces the Pallas kernel `_gn_kernel` driven by `_gn_pallas` /
`fused_group_norm` (the JAX package's ops/fused_norm.py:53, 83-103, 127):
per-group mean and biased variance in f32, the affine folded into
`y = x * a + b`, an optional SiLU, one read and one write of x.

Layout: the port's modules are NCHW, where the channels of one group are
contiguous, so one (sample, group) is one contiguous run of
`C/G * H * W` values; the kernel holds a run in registers (up to
MAX_GROUP values), so x is read once and y written once.

Two entry points: `sdt_group_norm_f32` and `sdt_group_norm_bf16` (bf16 x
and y, f32 affine and statistics, y rounded once on the store: the JAX
kernel writes `o_ref.dtype`, bf16 under `use_bf16`). The wrapper takes the
one of x's dtype and raises on any other dtype; `group_norm_reference`,
which rounds once to x's dtype, is the plain twin of both.

The wrapper's host work a call is the checks, one `torch.empty_like` and
one ctypes call; the autograd.Function is entered only when a gradient
can flow (serving runs under `torch.inference_mode`).
"""

import torch

from . import _cuda

KERNEL_NAME = "gn_silu"
ROUTE = "cuda"
SOURCE = "slotdiffusion_tpu_torch/csrc/group_norm.cu"
REPLACES = "ops/fused_norm.py:53"  # in the JAX package
MAX_GROUP = 32768  # values of one (sample, group) the kernel holds

ENTRY = {torch.float32: "sdt_group_norm_f32",
         torch.bfloat16: "sdt_group_norm_bf16"}
# kernel launches since ops.reset_launch_counts(), by entry point
launches = dict.fromkeys(ENTRY.values(), 0)


def group_norm_reference(x, weight, bias, num_groups, eps=1e-5, act=None):
    """Plain version: GroupNorm over NCHW with f32 statistics (biased
    variance), f32 affine and optional SiLU, rounded once to x's dtype;
    the CPU path of `fused_group_norm`."""
    B, C = x.shape[:2]
    xf = x.float().reshape(B, num_groups, -1)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def check_inputs(x, weight, bias, num_groups, act):
    """Raise ValueError unless the kernel takes these arguments: a
    contiguous f32 or bf16 NCHW tensor, f32 [C] affine on its device, whole
    groups of at most MAX_GROUP values."""
    if act not in (None, "silu"):
        raise ValueError(f"fused_group_norm: unsupported act {act!r}")
    if x.dtype not in ENTRY or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_group_norm takes a contiguous f32 or bf16 "
                         f"NCHW tensor, got {x.dtype} {tuple(x.shape)} "
                         f"strides {x.stride()}")
    B, C, H, W = x.shape
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    for p in (weight, bias):
        if p.shape != (C,) or p.dtype != torch.float32 or \
                p.device != x.device or not p.is_contiguous():
            raise ValueError("fused_group_norm: weight/bias must be "
                             "contiguous f32 [C] on the input's device")
    if C // num_groups * H * W > MAX_GROUP:
        raise ValueError(f"a group of {C // num_groups * H * W} values "
                         f"exceeds the kernel's {MAX_GROUP}")


def _forward(x, weight, bias, num_groups, eps, act):
    if x.device.type == "cpu":
        return group_norm_reference(x, weight, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    check_inputs(x, weight, bias, num_groups, act)
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    entry = ENTRY[x.dtype]
    err = getattr(_cuda.lib(), entry)(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), B,
        C, H * W, num_groups, eps, act == "silu", _cuda.stream_ptr(x.device))
    _cuda.check(err, entry)
    launches[entry] += 1
    return y


class FusedGroupNorm(torch.autograd.Function):
    """Forward: the CUDA kernel (CUDA) or the plain version (CPU).
    Backward: autograd of `group_norm_reference` recomputed at the saved
    (x, weight, bias), as the JAX custom_vjp's `_fgn_bwd`
    (ops/fused_norm.py:126-155 of the JAX package)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (num_groups, eps, act)
        return _forward(x, weight, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, gy):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = group_norm_reference(*inputs, *ctx.args)
            grads = torch.autograd.grad(y, inputs, gy)
        return (*grads, None, None, None)


def fused_group_norm(x, weight, bias, num_groups, eps=1e-5, act=None):
    """GroupNorm(+SiLU) over NCHW `x`: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor; differentiable through
    `FusedGroupNorm` (entered only when a gradient can flow)."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return FusedGroupNorm.apply(x, weight, bias, num_groups, eps, act)
    return _forward(x, weight, bias, num_groups, eps, act)
