"""GroupNorm(+SiLU) in one pass: a Triton kernel and its plain version.

Replaces the Pallas kernel `_gn_kernel` driven by `_gn_pallas` /
`fused_group_norm` (the JAX package's ops/fused_norm.py:53, 83-103, 126):
per-group mean and biased variance in f32, the affine folded into
`y = x * a + b`, an optional SiLU, one read and one write of x.

Layout: the port's modules are NCHW, where the channels of one group are
contiguous, so one (sample, group) is one contiguous run of
`C/G * H * W` values. The kernel runs one program per (sample, group) and
holds the whole run in registers (at most 12,288 values on the flagship
UNet: the 32x32 skip-concat ResBlock with 384 channels), so x is read once
and y written once.

Bound on the H100: ~10 flops per 8 bytes moved, far below the card's
~20 flops/byte f32 balance, so the kernel is bound by bytes: its floor is
2 * B * C * H * W * 4 bytes over 3.35 TB/s. The design moves exactly those
bytes; what it does not do is keep the tensor out of memory between the
GN and the conv that consumes it (a later fusion).
"""

import os

import torch

KERNEL_NAME = "gn_silu"
ROUTE = "triton"
SOURCE = "slotdiffusion_tpu_torch/ops/fused_norm.py"
REPLACES = "ops/fused_norm.py:53"  # in the JAX package
MAX_GROUP = 32768  # values of one (sample, group) the kernel holds

launches = 0  # kernel launches since ops.reset_launch_counts()

_kernel = None


def group_norm_reference(x, weight, bias, num_groups, eps=1e-5, act=None):
    """Plain version: GroupNorm over NCHW with f32 statistics (biased
    variance) and optional SiLU; the CPU path of `fused_group_norm`."""
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


def _build_kernel():
    # Triton's compile cache stays inside the checkout (.gitignore'd)
    # unless the caller chose another directory
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "_build", "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def gn_kernel(x_ptr, w_ptr, b_ptr, y_ptr, G, CG, HW, eps,
                  ACT: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)  # sample * G + group
        g = pid % G
        n = CG * HW
        base = pid.to(tl.int64) * n
        offs = tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(x_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / n
        xc = tl.where(m, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / n
        rstd = 1.0 / tl.sqrt(var + eps)
        c = g * CG + offs // HW
        w = tl.load(w_ptr + c, mask=m, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + c, mask=m, other=0.0).to(tl.float32)
        a = rstd * w
        y = x * a + (b - mean * a)
        if ACT:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + base + offs, y, mask=m)

    return triton, gn_kernel


def check_inputs(x, weight, bias, num_groups, act):
    """Raise ValueError unless the kernel takes these arguments: a
    contiguous f32 NCHW tensor, f32 [C] affine on its device, whole groups
    of at most MAX_GROUP values."""
    if act not in (None, "silu"):
        raise ValueError(f"fused_group_norm: unsupported act {act!r}")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_group_norm takes a contiguous f32 NCHW "
                         f"tensor, got {x.dtype} {tuple(x.shape)} "
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
    global _kernel, launches
    if x.device.type == "cpu":
        return group_norm_reference(x, weight, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    check_inputs(x, weight, bias, num_groups, act)
    B, C, H, W = x.shape
    CG, HW = C // num_groups, H * W
    if _kernel is None:
        _kernel = _build_kernel()
    triton, kernel = _kernel
    block = max(triton.next_power_of_2(CG * HW), 128)
    warps = 4 if block <= 2048 else (8 if block <= 8192 else 16)
    y = torch.empty_like(x)
    kernel[(B * num_groups,)](x, weight, bias, y, num_groups, CG, HW,
                              float(eps), ACT=act == "silu", BLOCK=block,
                              num_warps=warps)
    launches += 1
    return y


class FusedGroupNorm(torch.autograd.Function):
    """Forward: the Triton kernel (CUDA) or the plain version (CPU).
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
    """GroupNorm(+SiLU) over NCHW `x`: the Triton kernel for a CUDA tensor,
    the plain version for a CPU tensor; differentiable through
    `FusedGroupNorm`."""
    return FusedGroupNorm.apply(x, weight, bias, num_groups, eps, act)
