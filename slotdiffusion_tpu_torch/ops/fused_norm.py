"""GroupNorm(+SiLU) in one pass: a CUDA kernel (`csrc/group_norm.cu`)
and its plain version.

Replaces the Pallas kernel `_gn_kernel` driven by `_gn_pallas` /
`fused_group_norm` (the JAX package's ops/fused_norm.py:53, 83-103, 127):
per-group mean and biased variance in f32, the affine folded into
`y = x * a + b`, an optional SiLU, one read and one write of x.

Layout: the port's modules are NCHW, where the channels of one group are
contiguous, so one (sample, group) is one contiguous run of
`C/G * H * W` values; the f32 kernel holds a run of up to MAX_GROUP
values in registers, so x is read once and y written once. A longer run (the
UNet's 384-channel norm at 56x56 latents, the pixel decoder at 64x64)
takes the kernel's two-pass path: `long_plan` splits it into chunks of
at most LONG_CHUNK values, a first kernel writes each chunk's mean and
centered sum of squares into a workspace the wrapper allocates, and a
second combines a run's chunks in order (Chan's formula) and writes y.

Two entry points: `sdt_group_norm_f32` and `sdt_group_norm_bf16` (bf16 x
and y, f32 affine and statistics, y rounded once on the store: the JAX
kernel writes `o_ref.dtype`, bf16 under `use_bf16`). The wrapper takes the
one of x's dtype and raises on any other dtype; `group_norm_reference`,
which rounds once to x's dtype, is the plain twin of both.

The bf16 entry has three routes (`bf16_route`): "bulk", runs of a
multiple of 8 values, at most BULK_MAX_RUN, on 16-byte aligned x and y,
read once into shared memory by bulk copies and reduced there by teams
of threads, on a plan the launch computes from the call's shape and the
card (`bulk_plan` in csrc/gn_bulk_plan.cuh); "two_pass" for longer runs
(`long_plan`); "ragged" for the rest (the f32 entry's register kernel,
on bf16). `route_launches` counts its launches by route.

Under programmatic dependent launch a kernel reads nothing before the
kernel ahead of it on the stream has completed: x, weight and bias may
all be that kernel's output.

The wrapper's host work a call is the checks, one `torch.empty_like` and
one ctypes call; the autograd.Function is entered only when a gradient
can flow (serving runs under `torch.inference_mode`).

The forward is also the PyTorch operator `sdt::group_norm`, so that
`torch.export` records it as one node: its CPU implementation is the
plain version, its CUDA one the same ctypes launch, its fake one the
output's shape and dtype. Eager calls skip the dispatcher and call the
launch directly; only a call made while exporting goes through the
operator (`_forward`).
"""

import torch

from . import _cuda

KERNEL_NAME = "gn_silu"
ROUTE = "cuda"
SOURCE = "slotdiffusion_tpu_torch/csrc/group_norm.cu"
REPLACES = "ops/fused_norm.py:53"  # in the JAX package
MAX_GROUP = 32768  # values of one (sample, group) the kernel holds
LONG_CHUNK = 8192  # at most this many values a chunk of the long path

BULK_MAX_RUN = 98304  # bf16 values of a run the bulk route holds

ENTRY = {torch.float32: "sdt_group_norm_f32",
         torch.bfloat16: "sdt_group_norm_bf16"}
# kernel launches since ops.reset_launch_counts(), by entry point
launches = dict.fromkeys(ENTRY.values(), 0)
# the bf16 entry's launches by route, counted and reset with `launches`
ROUTES = ("bulk", "two_pass", "ragged")
route_launches = {f"sdt_group_norm_bf16.{r}": 0 for r in ROUTES}


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


def long_plan(L):
    """The long path's split of a run of L > MAX_GROUP values: -> (chunk,
    count), as few chunks of at most LONG_CHUNK values as hold the run,
    of one size rounded up to a multiple of 4; chunk i covers values
    [i * chunk, min((i + 1) * chunk, L)), the last one the shortest. The
    kernel combines them in that order."""
    count = -(-L // LONG_CHUNK)
    chunk = -(-L // count)
    chunk += -chunk % 4
    return chunk, -(-L // chunk)


def bf16_route(L, aligned):
    """The bf16 entry's route for runs of L values; `aligned`: x and y
    16-byte aligned. The kernel takes the same one (`bulk_route` in
    csrc/gn_bulk_plan.cuh, else the f32 entry's choice by MAX_GROUP)."""
    if aligned and L % 8 == 0 and L <= BULK_MAX_RUN:
        return "bulk"
    return "two_pass" if L > MAX_GROUP else "ragged"


def check_inputs(x, weight, bias, num_groups, act):
    """Raise ValueError unless the kernel takes these arguments: a
    contiguous f32 or bf16 NCHW tensor, f32 [C] affine on its device, whole
    groups (of any length: over MAX_GROUP values they take the two-pass
    path)."""
    if act not in (None, "silu"):
        raise ValueError(f"fused_group_norm: unsupported act {act!r}")
    if x.dtype not in ENTRY or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_group_norm takes a contiguous f32 or bf16 "
                         f"NCHW tensor, got {x.dtype} {tuple(x.shape)} "
                         f"strides {x.stride()}")
    B, C, H, W = x.shape
    if num_groups <= 0 or C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    for p in (weight, bias):
        if p.shape != (C,) or p.dtype != torch.float32 or \
                p.device != x.device or not p.is_contiguous():
            raise ValueError("fused_group_norm: weight/bias must be "
                             "contiguous f32 [C] on the input's device")


@_cuda.traced("sdt::group_norm")
def _launch(x, weight, bias, num_groups, eps, act):
    """The CUDA kernel on a CUDA `x`; a run over MAX_GROUP values off the
    bulk route gets the long path's plan and workspace."""
    check_inputs(x, weight, bias, num_groups, act)
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    L = C // num_groups * H * W
    work, chunk = None, 0
    route = "two_pass" if L > MAX_GROUP else None
    if x.dtype == torch.bfloat16:
        route = bf16_route(L, (x.data_ptr() | y.data_ptr()) % 16 == 0)
    if route == "two_pass":
        chunk, count = long_plan(L)
        work = torch.empty(B * num_groups * count * 2, dtype=torch.float32,
                           device=x.device)
    entry = ENTRY[x.dtype]
    err = getattr(_cuda.lib(), entry)(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), B,
        C, H * W, num_groups, eps, act == "silu",
        None if work is None else work.data_ptr(), chunk,
        _cuda.stream_ptr(x.device))
    _cuda.check(err, entry)
    launches[entry] += 1
    if x.dtype == torch.bfloat16:
        route_launches[f"{entry}.{route}"] += 1
    return y


@torch.library.custom_op("sdt::group_norm", mutates_args=(),
                         device_types="cpu")
def group_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm(+SiLU) as an operator: on the CPU the plain version."""
    return group_norm_reference(x, weight, bias, num_groups, eps,
                                "silu" if silu else None)


@group_norm_op.register_kernel("cuda")
def _(x, weight, bias, num_groups, eps, silu):
    return _launch(x, weight, bias, num_groups, eps, "silu" if silu else None)


@group_norm_op.register_fake
def _(x, weight, bias, num_groups, eps, silu):
    return torch.empty_like(x)


def _forward(x, weight, bias, num_groups, eps, act):
    if act not in (None, "silu"):
        raise ValueError(f"fused_group_norm: unsupported act {act!r}")
    if torch.compiler.is_exporting():
        return group_norm_op(x, weight, bias, num_groups, eps, act == "silu")
    if x.device.type == "cpu":
        return group_norm_reference(x, weight, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    return _launch(x, weight, bias, num_groups, eps, act)


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
