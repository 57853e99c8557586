"""All slot-attention iterations in one CUDA kernel
(`csrc/slot_attention.cu`) and its plain version.

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
`x @ W` orientation, GRU gates packed r | z | n).
"""

import torch

from . import _cuda

KERNEL_NAME = "slot_attention"
ROUTE = "cuda"
SOURCE = "slotdiffusion_tpu_torch/csrc/slot_attention.cu"
REPLACES = "ops/slot_attention_kernel.py:134"  # in the JAX package
MAX_SLOTS, MAX_D, MAX_M = 16, 256, 1024  # what one block holds

SA_WEIGHT_KEYS = ("wq", "ln_q_scale", "ln_q_bias", "gru_wi", "gru_bi",
                  "gru_wh", "gru_bh", "ln_mlp_scale", "ln_mlp_bias",
                  "w1", "b1", "w2", "b2")
# torch nn.LayerNorm default eps, as the JAX kernel uses
_LN_EPS = 1e-5

launches = 0  # kernel launches since ops.reset_launch_counts()


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


def sa_iterations(k, v, slots, p, *, num_iterations, eps,
                  return_last_attn=False, kv_dtype=torch.bfloat16):
    """Slot-attention refinement: the CUDA kernel for CUDA tensors (bf16
    k/v only), the plain version for CPU tensors."""
    global launches
    if k.device.type == "cpu":
        return sa_iterations_ref(
            k, v, slots, p, num_iterations=num_iterations, eps=eps,
            return_last_attn=return_last_attn, kv_dtype=kv_dtype)
    if k.device.type != "cuda":
        raise ValueError(f"sa_iterations: unsupported device {k.device}")
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
    err = _cuda.lib().sdt_sa_iterations_bf16(
        kb.data_ptr(), vb.data_ptr(), s0.data_ptr(),
        *[t.data_ptr() for t in w], out.data_ptr(), mask.data_ptr(),
        B, N, S, D, M, num_iterations, float(eps), float(D ** -0.5),
        int(return_last_attn), _cuda.stream_ptr(k.device))
    _cuda.check(err, "sdt_sa_iterations_bf16")
    launches += 1
    if return_last_attn:
        return out, mask
    return out
