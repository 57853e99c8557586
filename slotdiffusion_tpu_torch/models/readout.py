"""The Physion VQA readout head (mirrors the JAX package's
models/readout.py:20-66): `linear1` over every slot pair of each frame,
the pairs in `itertools.combinations` order, each the concatenation of
its two slots; the relations aggregated over the pairs (sum, mean or
max), `linear2` to one logit per frame in f32 whatever the compute dtype,
the max over the frames; the numerically stable BCE with logits; at
eval, the accuracy at each sigmoid threshold of `np.arange(0.1, 1, 0.2)`
(`acc_0.10`, ..., `acc_0.90`)."""

from itertools import combinations

import numpy as np
import torch
from torch import nn

from .blocks import Linear


class PhysionReadout(nn.Module):
    use_ema = False
    ema_prefix = ""
    frozen_modules = ()
    # what the trainer hands `compute_losses` from a batch
    batch_keys = ("slots", "label")

    def __init__(self, readout_dict, compute_dtype=torch.float32):
        super().__init__()
        rd = readout_dict
        self.num_slots = rd["num_slots"]
        self.slot_size = rd["slot_size"]
        self.agg_func = rd.get("agg_func", "max")
        if self.agg_func not in ("sum", "mean", "max"):
            raise ValueError(f"unknown aggregation {self.agg_func!r}")
        feats_dim = rd.get("feats_dim", self.slot_size)
        self.register_buffer("comb_idx", torch.tensor(
            list(combinations(range(self.num_slots), 2)), dtype=torch.long),
            persistent=False)
        self.linear1 = Linear(2 * self.slot_size, feats_dim,
                              compute_dtype=compute_dtype)
        self.linear2 = Linear(feats_dim, 1)

    def forward(self, data_dict, train=True):
        slots = data_dict["slots"]  # [B, T, N, C]
        B, T = slots.shape[:2]
        pairs = slots[:, :, self.comb_idx].reshape(B, T, -1,
                                                   2 * slots.shape[-1])
        relation = self.linear1(pairs)  # [B, T, pairs, F]
        if self.agg_func == "sum":
            relation = relation.sum(2)
        elif self.agg_func == "mean":
            relation = relation.mean(2)
        else:
            relation = relation.amax(2)
        return {"logits": self.linear2(relation)[..., 0].amax(1)}  # [B]

    def compute_losses(self, data_dict, generator=None, sched=None,
                       train=True):
        """-> (out, {"vqa_loss"} and at eval the accuracies). Nothing here
        draws: `generator` and `sched` are unused."""
        out = self(data_dict, train=train)
        logits = out["logits"].float()
        gt = data_dict["label"].reshape(-1).float().to(logits.device)
        losses = {"vqa_loss": torch.mean(
            torch.clamp(logits, min=0) - logits * gt +
            torch.log1p(torch.exp(-logits.abs())))}
        if not train:
            probs = torch.sigmoid(logits)
            for thresh in np.arange(0.1, 1, 0.2):
                losses[f"acc_{thresh:.2f}"] = (
                    (probs > float(thresh)) == (gt > 0.5)).float().mean()
        return out, losses
