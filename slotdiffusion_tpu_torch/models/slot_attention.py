"""Slot Attention with the last-iteration mask (mirrors
the JAX package's models/slot_attention.py:64-170). Parameter names
follow the upstream torch module (norm_inputs, project_k/v/q, gru, mlp).

k and v are computed once from LN(inputs); the iterations run in
`ops.slot_attention_kernel`: `use_pallas=True` (the flagship's setting)
takes the fused kernel, which streams k/v in bf16 (on the CPU its plain
twin, also in bf16); `use_pallas=False` the plain f32 formula, which is
what the JAX module computes off the TPU; `"auto"` (the JAX default) the
kernel for CUDA inputs and the f32 formula for CPU inputs.
"""

import torch
from torch import nn

from ..ops.slot_attention_kernel import sa_iterations, sa_iterations_ref


class SlotAttention(nn.Module):
    def __init__(self, in_features, num_iterations, slot_size,
                 mlp_hidden_size, eps=1e-6, return_last_attn=False,
                 use_pallas=True):
        super().__init__()
        D, M = slot_size, mlp_hidden_size
        self.num_iterations = num_iterations
        self.eps = eps
        self.return_last_attn = return_last_attn
        self.use_pallas = use_pallas
        self.norm_inputs = nn.LayerNorm(in_features)
        self.project_k = nn.Linear(in_features, D, bias=False)
        self.project_v = nn.Linear(in_features, D, bias=False)
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
        k, v = self.project_k(x), self.project_v(x)
        kw = dict(num_iterations=self.num_iterations, eps=self.eps,
                  return_last_attn=self.return_last_attn)
        use = self.use_pallas
        if use == "auto":
            use = x.device.type == "cuda"
        if use:
            return sa_iterations(k, v, slots, self.kernel_weights(), **kw)
        return sa_iterations_ref(k, v, slots, self.kernel_weights(),
                                 kv_dtype=torch.float32, **kw)
