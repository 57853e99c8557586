"""Slot transition predictors of SAVi (mirrors the JAX package's models/
predictor.py:18-160): the transformer over the slot set, pre-norm or
post-norm (torch TransformerEncoderLayer semantics, ReLU FFN), the
residual MLP, and the LSTM wrapper around either.

Parameter names follow the upstream modules: the transformer's
`transformer_encoder.layers.i.{self_attn, norm1, norm2, linear1,
linear2}`; the MLP's `ln` and `mlp.{0, 2}`; the wrapper's
`base_predictor.*`, `rnn.{weight,bias}_{ih,hh}_l{i}` (torch LSTM layout,
gates i, f, g, o) and `out_projector`. Everything computes in
`compute_dtype`, the attention as flax's `MultiHeadDotProductAttention
(dtype)`: q scaled by 1/sqrt(head width), logits, softmax and the value
product all in the compute dtype, the softmax in bf16 rounded where
`jax.nn.softmax` rounds (after the max's difference, the exponential,
the sum and the quotient).

The LSTM cell is flax's `OptimizedLSTMCell`: the recurrent product with
its bias, plus the input product (no bias of its own; a converted
checkpoint carries the combined bias in `bias_ih` and zeros in
`bias_hh`, and the cell adds both). The wrapper's state is threaded by
the caller: `forward(x, carry)` -> (prediction, carry), `carry=None`
starting from zeros; the carry holds each layer's (c, h) and the step
count, and with `sg_every = k` the input and the state are detached at
every step k, 2k, ... (not at step 0), as the JAX wrapper stops their
gradient.
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
        s = q @ k.transpose(-1, -2)
        if dt == torch.float32:
            w = torch.softmax(s, -1)
        else:  # rounded where jax.nn.softmax rounds: difference, exp, sum
            e = torch.exp(s - s.amax(-1, keepdim=True))
            w = e / e.sum(-1, keepdim=True)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, S, D))


class TransformerEncoderLayer(nn.Module):
    """torch's TransformerEncoderLayer (ReLU FFN, no dropout), pre-norm
    (`norm_first`) or post-norm, computing as flax's layers of the JAX
    package in `compute_dtype`."""

    def __init__(self, d_model, num_heads, ffn_dim, norm_first=True,
                 compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.norm_first = norm_first
        self.self_attn = _SelfAttention(d_model, num_heads, **dt)
        self.norm1 = LayerNorm(d_model, **dt)
        self.norm2 = LayerNorm(d_model, **dt)
        self.linear1 = Linear(d_model, ffn_dim, **dt)
        self.linear2 = Linear(ffn_dim, d_model, **dt)

    def _ffn(self, x):
        return self.linear2(torch.relu(self.linear1(x)))

    def forward(self, x):
        if self.norm_first:
            x = x + self.self_attn(self.norm1(x))
            return x + self._ffn(self.norm2(x))
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self._ffn(x))


class TransformerEncoder(nn.Module):
    """The layers under torch's name (`layers.i`)."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerPredictor(nn.Module):
    """TransformerEncoder over the slot set: [B, S, D] -> same; pre-norm
    (`norm_first`, the default) or post-norm."""

    def __init__(self, d_model, num_layers=1, num_heads=4, ffn_dim=256,
                 norm_first=True, compute_dtype=torch.float32):
        super().__init__()
        self.transformer_encoder = TransformerEncoder(
            [TransformerEncoderLayer(d_model, num_heads, ffn_dim,
                                     norm_first, compute_dtype)
             for _ in range(num_layers)])

    def forward(self, x):
        for layer in self.transformer_encoder.layers:
            x = layer(x)
        return x


class ResidualMLPPredictor(nn.Module):
    """LN -> Linear -> ReLU -> ... -> Linear, plus a residual: the normed
    input with `norm_first`, else the input itself. `channels` lists the
    widths, input first."""

    def __init__(self, channels, norm_first=True,
                 compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.norm_first = norm_first
        self.ln = LayerNorm(channels[0], **dt)
        layers = []
        for cin, cout in zip(channels[:-1], channels[1:]):
            layers += [Linear(cin, cout, **dt), nn.ReLU()]
        self.mlp = nn.Sequential(*layers[:-1])

    def forward(self, x):
        res = None if self.norm_first else x
        x = self.ln(x)
        if self.norm_first:
            res = x
        return self.mlp(x) + res


class RNNPredictorWrapper(nn.Module):
    """base predictor -> LSTM over the frames (one step a call, each slot
    its own sequence) -> `out_projector` back to the slot width."""

    def __init__(self, base, input_size, hidden_size=256, num_layers=1,
                 sg_every=None, compute_dtype=torch.float32):
        super().__init__()
        self.base_predictor = base
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.sg_every = sg_every
        self.compute_dtype = compute_dtype
        self.rnn = nn.LSTM(input_size, hidden_size, num_layers)
        self.out_projector = Linear(hidden_size, input_size,
                                    compute_dtype=compute_dtype)

    def zero_carry(self, rows, device):
        """The state a clip starts from: zeros for each layer's (c, h)
        over `rows` = batch x slots sequences, step 0."""
        z = lambda: torch.zeros(rows, self.hidden_size,
                                dtype=self.compute_dtype, device=device)
        return {"states": tuple((z(), z()) for _ in range(self.num_layers)),
                "step": 0}

    def _cell(self, layer, state, x):
        """flax OptimizedLSTMCell: gates = (h W_h + b) + x W_i, in the
        order i, f, g, o; -> (c', h')."""
        c, h = state
        r, dt = self.rnn, self.compute_dtype
        bias = getattr(r, f"bias_ih_l{layer}") + \
            getattr(r, f"bias_hh_l{layer}")
        gates = linear(h, getattr(r, f"weight_hh_l{layer}"), bias, dt) + \
            linear(x, getattr(r, f"weight_ih_l{layer}"), None, dt)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def forward(self, x, carry=None):
        """x [B, N, C] -> (prediction [B, N, C], the next carry)."""
        B, N, C = x.shape
        if carry is None:
            carry = self.zero_carry(B * N, x.device)
        states, step = carry["states"], carry["step"]
        if self.sg_every is not None and step > 0 and \
                step % self.sg_every == 0:
            x = x.detach()
            states = tuple((c.detach(), h.detach()) for c, h in states)
        h = self.base_predictor(x).reshape(B * N, C)
        new_states = []
        for layer, st in enumerate(states):
            st = self._cell(layer, st, h)
            new_states.append(st)
            h = st[1]
        out = self.out_projector(h).reshape(B, N, C)
        return out, {"states": tuple(new_states), "step": step + 1}


def build_predictor(pred_dict, slot_size, rnn_hidden_size=None,
                    compute_dtype=torch.float32):
    """The predictor a SAVi config asks for (the JAX `build_predictor`):
    "transformer" or "mlp", wrapped in the LSTM with `pred_rnn` (its width
    `rnn_hidden_size`, the config's `slot_mlp_size`, else twice the slot
    size); None for a `pred_type` of None, "" or "none". Another type
    raises."""
    ptype = pred_dict.get("pred_type", "transformer")
    norm_first = pred_dict.get("pred_norm_first", True)
    if ptype == "transformer":
        base = TransformerPredictor(
            d_model=slot_size,
            num_layers=pred_dict.get("pred_num_layers", 2),
            num_heads=pred_dict.get("pred_num_heads", 4),
            ffn_dim=pred_dict.get("pred_ffn_dim", slot_size * 4),
            norm_first=norm_first, compute_dtype=compute_dtype)
    elif ptype == "mlp":
        base = ResidualMLPPredictor(
            (slot_size, slot_size * 2, slot_size), norm_first=norm_first,
            compute_dtype=compute_dtype)
    elif ptype in (None, "", "none"):
        return None
    else:
        raise ValueError(f"unknown predictor {ptype!r}")
    if pred_dict.get("pred_rnn", False):
        return RNNPredictorWrapper(
            base, slot_size, rnn_hidden_size or slot_size * 2,
            sg_every=pred_dict.get("pred_sg_every", None),
            compute_dtype=compute_dtype)
    return base
