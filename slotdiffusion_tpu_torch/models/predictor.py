"""Transformer slot predictor (mirrors the JAX package's models/
predictor.py:18-54, 128-160): pre-norm torch TransformerEncoderLayer
semantics, ReLU FFN. Parameter names follow torch's
`transformer_encoder.layers.i.{self_attn, norm1, norm2, linear1, linear2}`.
Everything computes in `compute_dtype`, the attention as flax's
`MultiHeadDotProductAttention(dtype)`: q scaled by 1/sqrt(head width),
logits, softmax and the value product all in the compute dtype.
"""

import math

import torch
from torch import nn

from .blocks import LayerNorm, Linear, linear


class _SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj), plain math."""

    def __init__(self, d_model, num_heads, compute_dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        # flax divides q by sqrt(head width) rounded to the compute dtype
        self.q_div = torch.tensor(math.sqrt(d_model // num_heads)).to(
            compute_dtype).item()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model, compute_dtype=compute_dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        B, S, D = x.shape
        H, dt = self.num_heads, self.compute_dtype
        qkv = linear(x, self.in_proj_weight, self.in_proj_bias, dt)
        q, k, v = (t.reshape(B, S, H, D // H).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        q = q / self.q_div
        w = torch.softmax(q @ k.transpose(-1, -2), -1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, S, D))


class _EncoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, ffn_dim,
                 compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.self_attn = _SelfAttention(d_model, num_heads, **dt)
        self.norm1 = LayerNorm(d_model, **dt)
        self.norm2 = LayerNorm(d_model, **dt)
        self.linear1 = Linear(d_model, ffn_dim, **dt)
        self.linear2 = Linear(ffn_dim, d_model, **dt)

    def forward(self, x):
        x = x + self.self_attn(self.norm1(x))
        return x + self.linear2(torch.relu(self.linear1(self.norm2(x))))


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerPredictor(nn.Module):
    """Pre-norm TransformerEncoder over the slot set: [B, S, D] -> same."""

    def __init__(self, d_model, num_layers=1, num_heads=4, ffn_dim=256,
                 compute_dtype=torch.float32):
        super().__init__()
        self.transformer_encoder = _Encoder(
            [_EncoderLayer(d_model, num_heads, ffn_dim, compute_dtype)
             for _ in range(num_layers)])

    def forward(self, x):
        for layer in self.transformer_encoder.layers:
            x = layer(x)
        return x


def build_predictor(pred_dict, slot_size, compute_dtype=torch.float32):
    """The predictor a SAVi config asks for; only the pre-norm transformer
    without the RNN wrapper (the flagship's) is ported."""
    if pred_dict.get("pred_type", "transformer") != "transformer" or \
            pred_dict.get("pred_rnn", False) or \
            not pred_dict.get("pred_norm_first", True):
        raise ValueError(f"predictor {pred_dict} is not ported yet")
    return TransformerPredictor(
        d_model=slot_size,
        num_layers=pred_dict.get("pred_num_layers", 2),
        num_heads=pred_dict.get("pred_num_heads", 4),
        ffn_dim=pred_dict.get("pred_ffn_dim", slot_size * 4),
        compute_dtype=compute_dtype)
