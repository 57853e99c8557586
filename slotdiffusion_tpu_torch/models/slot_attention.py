"""Slot Attention with the last-iteration mask (mirrors
the JAX package's models/slot_attention.py:64-170). Parameter names
follow the upstream torch module (norm_inputs, project_k/v/q, gru, mlp).

k and v are computed once from LN(inputs); the iterations run in
`ops.slot_attention_kernel`: `use_pallas=True` (the flagship's setting)
takes the fused kernel, which streams k/v in bf16 (on the CPU its plain
twin, also in bf16); `use_pallas=False` and `"auto"` (the JAX default,
which resolves to False there on every device) the plain f32 formula,
which is what the JAX module computes off the TPU.

Under `compute_dtype` (bf16 with `use_bf16`) the JAX module's precision
(models/slot_attention.py:121-149 of the JAX package): the input LN in
f32, the k/v projections in the compute dtype then held in f32, the
iterations in f32 from f32 slots, the slots returned in the compute dtype
and the mask in f32. Under bf16 the kernel's bf16 k/v are then exact
copies of the JAX values.
"""

import torch
from torch import nn

from ..ops.slot_attention_kernel import sa_iterations, sa_iterations_ref
from .blocks import Linear


class SlotAttention(nn.Module):
    def __init__(self, in_features, num_iterations, slot_size,
                 mlp_hidden_size, eps=1e-6, return_last_attn=False,
                 use_pallas=True, compute_dtype=torch.float32):
        super().__init__()
        D, M = slot_size, mlp_hidden_size
        self.num_iterations = num_iterations
        self.eps = eps
        self.return_last_attn = return_last_attn
        self.use_pallas = use_pallas
        self.compute_dtype = compute_dtype
        self.norm_inputs = nn.LayerNorm(in_features)
        self.project_k = Linear(in_features, D, bias=False,
                                compute_dtype=compute_dtype)
        self.project_v = Linear(in_features, D, bias=False,
                                compute_dtype=compute_dtype)
        self.project_q = nn.Sequential(nn.LayerNorm(D),
                                       nn.Linear(D, D, bias=False))
        self.gru = nn.GRUCell(D, D)
        self.mlp = nn.Sequential(nn.LayerNorm(D), nn.Linear(D, M), nn.ReLU(),
                                 nn.Linear(M, D))

    def kernel_weights(self):
        """The SA_WEIGHT_KEYS dict of the iteration kernel (x @ W layout)."""
        return {
            "wq": self.project_q[1].weight.t(),
            "ln_q_scale": self.project_q[0].weight,
            "ln_q_bias": self.project_q[0].bias,
            "gru_wi": self.gru.weight_ih.t(),
            "gru_bi": self.gru.bias_ih,
            "gru_wh": self.gru.weight_hh.t(),
            "gru_bh": self.gru.bias_hh,
            "ln_mlp_scale": self.mlp[0].weight,
            "ln_mlp_bias": self.mlp[0].bias,
            "w1": self.mlp[1].weight.t(),
            "b1": self.mlp[1].bias,
            "w2": self.mlp[3].weight.t(),
            "b2": self.mlp[3].bias,
        }

    def forward(self, inputs, slots):
        """inputs [B, N, C_in], slots [B, S, D] -> slots (and masks
        [B, S, N] if `return_last_attn`)."""
        x = self.norm_inputs(inputs.float())
        k, v = self.project_k(x).float(), self.project_v(x).float()
        kw = dict(num_iterations=self.num_iterations, eps=self.eps,
                  return_last_attn=self.return_last_attn)
        # "auto" resolves as the JAX package's does: to the f32 formula
        if self.use_pallas != "auto" and self.use_pallas:
            out = sa_iterations(k, v, slots.float(), self.kernel_weights(),
                                **kw)
        else:
            out = sa_iterations_ref(k, v, slots.float(),
                                    self.kernel_weights(),
                                    kv_dtype=torch.float32, **kw)
        if self.return_last_attn:
            return out[0].to(self.compute_dtype), out[1]
        return out.to(self.compute_dtype)
