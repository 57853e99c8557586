"""3x3 stride-1 SAME convolution by Winograd F(2x2, 3x3): a CUDA kernel
(`csrc/winograd.cu`) and its plain version.

Replaces the Pallas kernel `_wino_kernel` driven by `_wino_call` /
`winograd_conv3x3` (the JAX package's ops/winograd_conv.py:78-150,
180-198, 209-232). x [B, H, W, C] NHWC and w [3, 3, C, F] HWIO, no bias,
as in the JAX package: the weights become U = G g G^T [16, C, F] in f32,
rounded to bf16; each 4x4 input tile becomes V = B^T d B in f32, rounded
to bf16; 16 products [tiles, C] x [C, F] of bf16 operands accumulate in
f32; A^T M A maps them back to 2x2 outputs in x's dtype.

The JAX entry point splits the weight transform (`winograd_weights`,
then bf16) from the convolution on U (`_wino_call`); so does this module:
`kernel_weights(w)` gives U in the kernel's layout and
`winograd_conv3x3_u(x, u, F)` convolves with it, so a caller that keeps
U pays the transform once. `winograd_conv3x3(x, w)` does both on every
call, as the JAX entry point does.

No model calls it, as in the JAX package: its callers are this entry
point, `scripts/bench_torch_winograd.py` and the tests. The backward is
the direct convolution's gradients (`WinogradConv3x3`), as the JAX
custom_vjp's is.
"""

import torch
import torch.nn.functional as F

from . import _cuda

KERNEL_NAME = "winograd_conv3x3"
ROUTE = "cuda"
SOURCE = "slotdiffusion_tpu_torch/csrc/winograd.cu"
REPLACES = "ops/winograd_conv.py:78"  # in the JAX package

launches = 0  # convolutions launched since ops.reset_launch_counts()

# the products kernel's block (csrc/winograd.cu kMt, kNt, kKc): U^T is
# padded to whole blocks of output and input channels, V to whole blocks
# of tiles
TILE_M, TILE_N, TILE_K = 128, 64, 64

# The transforms of F(2x2, 3x3) as sums of slices, so that no constant
# tensor is built on the host (the functions can be captured in a CUDA
# graph): B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]],
# G = [[1,0,0],[.5,.5,.5],[.5,-.5,.5],[0,0,1]],
# A^T = [[1,1,1,0],[0,1,-1,-1]].

def _bt(t, dim):
    d0, d1, d2, d3 = t.unbind(dim)
    return torch.stack([d0 - d2, d1 + d2, d2 - d1, d1 - d3], dim)


def _g(t, dim):
    w0, w1, w2 = t.unbind(dim)
    return torch.stack([w0, (w0 + w1 + w2) * 0.5, (w0 - w1 + w2) * 0.5, w2],
                       dim)


def _at(t, dim):
    m0, m1, m2, m3 = t.unbind(dim)
    return torch.stack([m0 + m1 + m2, m1 - m2 - m3], dim)


def winograd_weights(w):
    """[3, 3, C, F] conv kernel -> transformed U = G g G^T [16, C, F], f32."""
    return _g(_g(w.float(), 0), 1).reshape(16, w.shape[2], w.shape[3])


def _ceil_to(n, m):
    return -(-n // m) * m


def winograd_reference(x, w):
    """Plain version with the kernel's rounding points: U and V in bf16,
    the 16 products and the inverse transform in f32, the output in x's
    dtype. Any H and W: an odd edge is padded with zeros and cropped."""
    return _reference_on_u(x, winograd_weights(w).to(torch.bfloat16).float())


def kernel_weights_reference(w):
    """Plain version of `kernel_weights`: U^T [16, Fp, Cp] in bf16, zero
    past C and F."""
    C, Fo = w.shape[2], w.shape[3]
    ut = winograd_weights(w).to(torch.bfloat16).transpose(1, 2)
    return F.pad(ut, (0, _ceil_to(C, TILE_K) - C, 0,
                      _ceil_to(Fo, TILE_N) - Fo))


def winograd_reference_u(x, ut, f):
    """Plain version of `winograd_conv3x3_u`: the convolution on U^T
    [16, Fp, Cp] (bf16) with `f` output channels."""
    return _reference_on_u(
        x, ut[:, :f, :x.shape[3]].transpose(1, 2).float())


def _reference_on_u(x, u):
    """`winograd_reference` on U [16, C, F] (bf16 values in f32)."""
    B, H, W, C = x.shape
    Fo = u.shape[-1]
    # SAME padding plus one zero row/column where H or W is odd
    xp = F.pad(x.float(), (0, 0, 1, 1 + W % 2, 1, 1 + H % 2))
    d = xp.unfold(1, 4, 2).unfold(2, 4, 2)  # [B, nth, ntw, C, 4, 4]
    nth, ntw = d.shape[1], d.shape[2]
    v = _bt(_bt(d, -2), -1)  # rows first, as the JAX kernel
    v = v.to(torch.bfloat16).float().reshape(-1, C, 16).permute(2, 0, 1)
    m = torch.bmm(v, u).reshape(4, 4, -1, Fo)      # [u, v, T, F]
    y = _at(_at(m, 0), 1).permute(2, 0, 1, 3)      # [T, a, b, F]
    y = y.reshape(B, nth, ntw, 2, 2, Fo).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(B, 2 * nth, 2 * ntw, Fo)[:, :H, :W]
    return y.to(x.dtype)


def direct_conv(x, w):
    """The direct 3x3 SAME convolution, NHWC x, HWIO w in x's dtype (the
    JAX package's `_direct_conv`): the backward's function."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def check_inputs(x, w):
    """Raise ValueError unless the kernel takes these arguments: a
    contiguous bf16 x [B, H, W, C] with C even (the kernel reads channel
    pairs), fewer than 2^31 tiles, and w [3, 3, C, F] on its device."""
    _check_x(x)
    if w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]) or \
            w.device != x.device:
        raise ValueError(f"winograd_conv3x3: weight {tuple(w.shape)} is not "
                         f"[3, 3, {x.shape[3]}, F] on {x.device}")


def _check_x(x):
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous() \
            or x.shape[3] % 2:
        raise ValueError("winograd_conv3x3 takes a contiguous bf16 NHWC "
                         f"tensor with an even C, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, H, W, _ = x.shape
    if B * ((H + 1) // 2) * ((W + 1) // 2) >= 2 ** 31 - 2 * TILE_M:
        raise ValueError(f"winograd_conv3x3: too many tiles in {x.shape}")


def kernel_weights(w):
    """w [3, 3, C, F] -> U^T [16, Fp, Cp] bf16 (U = G w G^T rounded to
    bf16, transposed and zero-padded to whole kernel blocks): the weight
    half of the JAX entry point. The CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if w.device.type == "cpu":
        return kernel_weights_reference(w)
    if w.device.type != "cuda" or w.dim() != 4 or w.shape[:2] != (3, 3):
        raise ValueError(f"kernel_weights: w {tuple(w.shape)} on "
                         f"{w.device} is not a [3, 3, C, F] CUDA tensor")
    C, Fo = w.shape[2], w.shape[3]
    wf = w.float().contiguous()
    ut = torch.empty((16, _ceil_to(Fo, TILE_N), _ceil_to(C, TILE_K)),
                     dtype=torch.bfloat16, device=w.device)
    err = _cuda.lib().sdt_winograd_weights_bf16(
        wf.data_ptr(), ut.data_ptr(), C, Fo, ut.shape[1], ut.shape[2],
        _cuda.stream_ptr(w.device))
    _cuda.check(err, "sdt_winograd_weights_bf16")
    return ut


def winograd_conv3x3_u(x, ut, f):
    """The convolution on U: x [B, H, W, C] and U^T from `kernel_weights`
    -> [B, H, W, f] in x's dtype. The CUDA kernels for a CUDA tensor (bf16
    only), the plain version for a CPU tensor. Not differentiable: the
    autograd path is `winograd_conv3x3`."""
    global launches
    if x.device.type == "cpu":
        return winograd_reference_u(x, ut, f)
    if x.device.type != "cuda":
        raise ValueError(f"winograd_conv3x3: unsupported device {x.device}")
    B, H, W, C = x.shape
    Fp, Cp = _ceil_to(f, TILE_N), _ceil_to(C, TILE_K)
    _check_x(x)
    if ut.shape != (16, Fp, Cp) or ut.dtype != torch.bfloat16 or \
            not ut.is_contiguous() or ut.device != x.device:
        raise ValueError(f"winograd_conv3x3_u: U^T {tuple(ut.shape)} "
                         f"{ut.dtype} is not kernel_weights' [16, {Fp}, "
                         f"{Cp}] bf16 on {x.device}")
    T = B * ((H + 1) // 2) * ((W + 1) // 2)
    Tp = _ceil_to(T, TILE_M)
    # split the (uv, channel chunk) steps over enough blocks to fill the
    # card when the tiles and channels alone give fewer blocks than SMs
    steps = 16 * Cp // TILE_K
    blocks = Tp // TILE_M * Fp // TILE_N
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = max(1, min(steps, sms // blocks))
    per_split = -(-steps // splits)
    splits = -(-steps // per_split)
    v = torch.empty((16, Tp, Cp), dtype=torch.bfloat16, device=x.device)
    yacc = torch.empty(splits * B * H * W * f, dtype=torch.float32,
                       device=x.device) if splits > 1 else None
    y = torch.empty((B, H, W, f), dtype=x.dtype, device=x.device)
    err = _cuda.lib().sdt_winograd_conv_bf16(
        x.data_ptr(), ut.data_ptr(), v.data_ptr(),
        None if yacc is None else yacc.data_ptr(), y.data_ptr(), B, H, W,
        C, f, Fp, Cp, Tp, per_split, _cuda.stream_ptr(x.device))
    _cuda.check(err, "sdt_winograd_conv_bf16")
    launches += 1
    return y


def _forward(x, w):
    if x.device.type == "cpu":
        return winograd_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"winograd_conv3x3: unsupported device {x.device}")
    check_inputs(x, w)
    return winograd_conv3x3_u(x, kernel_weights(w), w.shape[-1])


class WinogradConv3x3(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    direct convolution's gradients at the saved (x, w), with the cotangent
    in x's dtype, as the JAX custom_vjp's `_wc_bwd`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
            return torch.autograd.grad(direct_conv(xs, ws), (xs, ws),
                                       gy.to(x.dtype))


def winograd_conv3x3(x_nhwc, w_hwcf):
    """3x3 stride-1 SAME conv (no bias): x [B, H, W, C], w [3, 3, C, F]
    -> [B, H, W, F] in x's dtype. The CUDA kernel for a CUDA tensor (bf16
    only), the plain version for a CPU tensor."""
    return WinogradConv3x3.apply(x_nhwc, w_hwcf)
