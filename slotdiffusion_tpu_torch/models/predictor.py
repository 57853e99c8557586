"""Transformer slot predictor (mirrors the JAX package's models/
predictor.py:18-54, 128-160): pre-norm torch TransformerEncoderLayer
semantics, ReLU FFN. Parameter names follow torch's
`transformer_encoder.layers.i.{self_attn, norm1, norm2, linear1, linear2}`.
"""

import torch
from torch import nn


class _SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj), plain math."""

    def __init__(self, d_model, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        B, S, D = x.shape
        H = self.num_heads
        qkv = nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, S, H, D // H).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        w = torch.softmax((q @ k.transpose(-1, -2)) * (D // H) ** -0.5, -1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, S, D))


class _EncoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, ffn_dim):
        super().__init__()
        self.self_attn = _SelfAttention(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)

    def forward(self, x):
        x = x + self.self_attn(self.norm1(x))
        return x + self.linear2(torch.relu(self.linear1(self.norm2(x))))


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerPredictor(nn.Module):
    """Pre-norm TransformerEncoder over the slot set: [B, S, D] -> same."""

    def __init__(self, d_model, num_layers=1, num_heads=4, ffn_dim=256):
        super().__init__()
        self.transformer_encoder = _Encoder(
            [_EncoderLayer(d_model, num_heads, ffn_dim)
             for _ in range(num_layers)])

    def forward(self, x):
        for layer in self.transformer_encoder.layers:
            x = layer(x)
        return x


def build_predictor(pred_dict, slot_size):
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
        ffn_dim=pred_dict.get("pred_ffn_dim", slot_size * 4))
