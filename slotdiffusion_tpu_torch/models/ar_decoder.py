"""The autoregressive token decoder of SLATE and STEVE (mirrors the JAX
package's models/ar_decoder.py:27-256): a GPT-style decoder over dVAE
token ids, BOS = `vocab_size`, causal self-attention, the slots as
cross-attention memory, a learned position embedding, and generation
with a per-layer K/V cache.

Parameter names follow the upstream model: `in_proj`, `tok_emb`
(`vocab_size + 1` rows), `pos_emb.pe` [1, max_len + 1, d],
`tf_dec.blocks.i.{self_attn_layer_norm, self_attn, encoder_decoder_attn_
layer_norm, encoder_decoder_attn, ffn_layer_norm, ffn.0, ffn.2}` (each
attention's bias-free `proj_q`, `proj_k`, `proj_v`, `proj_o`),
`tf_dec.layer_norm` and the bias-free `head`.

What the JAX module computes, kept here:
- attention is plain matmuls: q scaled before the product, the logits in
  f32, a masked logit set to -inf, the softmax in f32 then cast to the
  compute dtype, the value product summed in f32 then cast;
- block 0 normalizes its input and keeps the normed x as the residual
  stream (post-LN on the first block); the others are pre-LN;
- the token and position embeddings and the head compute in f32;
- no dropout (the JAX decoder applies none).

`generate` is the JAX scan as a loop of single-token steps over static
shapes: K/V caches of `steps` positions a layer, the position a device
tensor (caches written and outputs stored with `index_copy_`, unwritten
cache entries masked by `pos >= valid length`), the cross-attention K/V
projected once; greedy, or sampled at `temperature` from an explicit
generator. A step does no host sync: on the card greedy generation
captures one step in a CUDA graph and replays it (the JAX package runs
its scan as one compiled program); on the CPU, and when sampling, the
steps run eagerly.
"""

import torch
from torch import nn

from .blocks import LayerNorm, Linear, linear


class ARMultiHeadAttention(nn.Module):
    """No-bias q/k/v/o attention with an optional mask (True = masked)."""

    def __init__(self, d_model, num_heads, gain=1.0,
                 compute_dtype=torch.float32):
        super().__init__()
        dt = dict(bias=False, compute_dtype=compute_dtype)
        self.d_model, self.num_heads, self.gain = d_model, num_heads, gain
        self.compute_dtype = compute_dtype
        self.proj_q = Linear(d_model, d_model, **dt)
        self.proj_k = Linear(d_model, d_model, **dt)
        self.proj_v = Linear(d_model, d_model, **dt)
        self.proj_o = Linear(d_model, d_model, **dt)

    def _split(self, x):
        B, T, C = x.shape
        return x.reshape(B, T, self.num_heads, C // self.num_heads
                         ).transpose(1, 2)

    def attend(self, q, k, v, mask=None):
        """Projected q [B, Tq, C], k, v [B, Tk, C] -> [B, Tq, C]."""
        q, k, v = self._split(q), self._split(k), self._split(v)
        q = q * q.shape[-1] ** -0.5
        logits = q.float() @ k.float().transpose(-1, -2)
        if mask is not None:
            logits = logits.masked_fill(mask, float("-inf"))
        w = torch.softmax(logits, dim=-1).to(self.compute_dtype)
        out = (w.float() @ v.float()).to(self.compute_dtype)
        B, _, T, _ = out.shape
        return out.transpose(1, 2).reshape(B, T, self.d_model)

    def forward(self, q_in, k_in, v_in, mask=None):
        return self.proj_o(self.attend(self.proj_q(q_in), self.proj_k(k_in),
                                       self.proj_v(v_in), mask))


class ARDecoderBlock(nn.Module):
    """Causal self-attention -> cross-attention on the slots -> ReLU FFN,
    each pre-LN, the first block post-LN on its input."""

    def __init__(self, d_model, num_heads, gain, is_first=False,
                 compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.is_first = is_first
        self.self_attn_layer_norm = LayerNorm(d_model, **dt)
        self.self_attn = ARMultiHeadAttention(d_model, num_heads, gain, **dt)
        self.encoder_decoder_attn_layer_norm = LayerNorm(d_model, **dt)
        self.encoder_decoder_attn = ARMultiHeadAttention(d_model, num_heads,
                                                         gain, **dt)
        self.ffn_layer_norm = LayerNorm(d_model, **dt)
        self.ffn = nn.Sequential(Linear(d_model, 4 * d_model, **dt),
                                 nn.ReLU(), Linear(4 * d_model, d_model, **dt))

    def _self_input(self, x):
        """-> (residual stream, self-attention input)."""
        h = self.self_attn_layer_norm(x)
        return (h, h) if self.is_first else (x, h)

    def _rest(self, x, memory_kv):
        ca = self.encoder_decoder_attn
        h = self.encoder_decoder_attn_layer_norm(x)
        x = x + ca.proj_o(ca.attend(ca.proj_q(h), *memory_kv))
        return x + self.ffn(self.ffn_layer_norm(x))

    def forward(self, x, memory_kv, causal_mask):
        x, h = self._self_input(x)
        x = x + self.self_attn(h, h, h, causal_mask)
        return self._rest(x, memory_kv)

    def step(self, x, memory_kv, k_cache, v_cache, pos):
        """One token [B, 1, C] at the device position `pos` [1]: its
        self-attention K/V written into the caches [B, L, C] at `pos`,
        the query attending to the entries up to and including it."""
        x, h = self._self_input(x)
        sa = self.self_attn
        k_cache.index_copy_(1, pos, sa.proj_k(h).to(k_cache.dtype))
        v_cache.index_copy_(1, pos, sa.proj_v(h).to(v_cache.dtype))
        unwritten = torch.arange(k_cache.shape[1], device=pos.device) > pos
        x = x + sa.proj_o(sa.attend(sa.proj_q(h), k_cache, v_cache,
                                    unwritten))
        return self._rest(x, memory_kv)


class _PosEmb(nn.Module):
    def __init__(self, length, d_model):
        super().__init__()
        self.pe = nn.Parameter(torch.zeros(1, length, d_model))


class _Blocks(nn.Module):
    def __init__(self, blocks, d_model, compute_dtype):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.layer_norm = LayerNorm(d_model, compute_dtype=compute_dtype)


class ARTransformerDecoder(nn.Module):
    """AR token decoder over `vocab_size` tokens, `max_len + 1` positions
    (BOS and `max_len` tokens), `num_layers` blocks of width `d_model`."""

    def __init__(self, vocab_size, d_model, n_head, max_len, num_slots,
                 num_layers, compute_dtype=torch.float32):
        super().__init__()
        self.vocab_size, self.d_model = vocab_size, d_model
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        gain = (3 * max(num_layers, 1)) ** -0.5
        self.in_proj = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.tok_emb = nn.Embedding(vocab_size + 1, d_model)
        self.pos_emb = _PosEmb(max_len + 1, d_model)
        self.tf_dec = _Blocks(
            [ARDecoderBlock(d_model, n_head, gain, i == 0, compute_dtype)
             for i in range(num_layers)], d_model, compute_dtype)
        self.head = nn.Linear(d_model, vocab_size, bias=False)

    def _logits(self, x):
        return linear(self.tf_dec.layer_norm(x), self.head.weight, None,
                      torch.float32)

    def _memory_kvs(self, slots):
        memory = self.in_proj(slots)
        return [(blk.encoder_decoder_attn.proj_k(memory),
                 blk.encoder_decoder_attn.proj_v(memory))
                for blk in self.tf_dec.blocks]

    def forward(self, slots, idx):
        """Teacher forcing: slots [B, S, C], input ids [B, T] (BOS is
        prepended here) -> logits [B, T + 1, vocab] (f32)."""
        B, T = idx.shape
        bos = torch.full((B, 1), self.vocab_size, dtype=idx.dtype,
                         device=idx.device)
        x = self.tok_emb(torch.cat([bos, idx], 1)) + self.pos_emb.pe[:, :T + 1]
        causal = torch.ones(T + 1, T + 1, dtype=torch.bool,
                            device=idx.device).triu(1)
        for blk, kv in zip(self.tf_dec.blocks, self._memory_kvs(slots)):
            x = blk(x, kv, causal)
        return self._logits(x)

    def _step(self, tok, pos, memory_kvs, caches, ids, logits, sample,
              temperature, generator):
        """Decode the token `tok` [B] at position `pos` [1]: write the
        next id and its logits into `ids` [B, steps], `logits` [B, steps,
        vocab] at `pos`; -> the next id [B]."""
        x = self.tok_emb(tok[:, None]) + \
            self.pos_emb.pe.index_select(1, pos)
        for blk, kv, (kc, vc) in zip(self.tf_dec.blocks, memory_kvs, caches):
            x = blk.step(x, kv, kc, vc, pos)
        out = self._logits(x)[:, 0]
        if sample:
            nxt = torch.multinomial(torch.softmax(out / temperature, -1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = out.argmax(-1)
        ids.index_copy_(1, pos, nxt[:, None])
        logits.index_copy_(1, pos, out[:, None])
        return nxt

    @torch.no_grad()
    def generate(self, slots, steps, sample=False, temperature=1.0,
                 generator=None, graphed=None):
        """`steps` tokens from BOS, each step one token's attention against
        the caches. -> (ids [B, steps] int64, logits [B, steps, vocab]
        f32). `sample` draws each id from softmax(logits / temperature)
        with `generator`, else takes the argmax. `graphed` (default: for
        greedy generation on a CUDA device) captures one step in a CUDA
        graph and replays it `steps` times, as the JAX package runs its
        scan as one program; sampled generation runs eagerly."""
        if sample and generator is None:
            raise ValueError("sampled generation needs a torch.Generator")
        if graphed is None:
            graphed = slots.is_cuda and not sample
        if graphed and (sample or not slots.is_cuda):
            raise ValueError("only greedy generation on a CUDA device runs "
                             "from a CUDA graph")
        B, dev = slots.shape[0], slots.device
        memory_kvs = self._memory_kvs(slots)
        # each layer's own attention width: the local heads' under TP
        caches = [tuple(torch.zeros(B, steps, blk.self_attn.d_model,
                                    dtype=self.compute_dtype, device=dev)
                        for _ in range(2)) for blk in self.tf_dec.blocks]
        ids = torch.zeros(B, steps, dtype=torch.long, device=dev)
        logits = torch.zeros(B, steps, self.vocab_size, device=dev)
        tok = torch.full((B,), self.vocab_size, dtype=torch.long, device=dev)
        pos = torch.zeros(1, dtype=torch.long, device=dev)

        def step():
            tok.copy_(self._step(tok, pos, memory_kvs, caches, ids, logits,
                                 sample, temperature, generator))
            pos.add_(1)

        if not graphed:
            for _ in range(steps):
                step()
            return ids, logits
        # a warm-up step on a side stream, then one captured; the warm-up
        # wrote position 0, which the first replay writes again
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        tok.fill_(self.vocab_size)
        pos.zero_()
        for _ in range(steps):
            graph.replay()
        return ids, logits
