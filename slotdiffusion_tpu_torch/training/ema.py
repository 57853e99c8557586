"""Exponential moving average of parameters (mirrors the JAX package's
training/ema.py:26-70, the upstream LitEma):

    n     += 1
    decay  = min(decay, (1 + n) / (10 + n))
    shadow = shadow - (1 - decay) * (shadow - param)

once per optimizer step. The shadow covers the parameters whose names
start with `prefix`: by default the model's `dm_decoder` (the subtree
the JAX trainer swaps in at eval for SAViDiffusion), "" for all of them;
`swapped` puts the shadow in place of those parameters for the duration
of a `with` block.
"""

import contextlib

import torch


PREFIX = "dm_decoder."


class ExponentialMovingAverage:
    def __init__(self, model, decay, prefix=PREFIX):
        self.decay = decay
        self.prefix = prefix
        self.num_updates = 0
        self.shadow = {n: p.detach().clone()
                       for n, p in self._tracked(model)}

    def _tracked(self, model):
        return [(n, p) for n, p in model.named_parameters()
                if n.startswith(self.prefix)]

    @torch.no_grad()
    def update(self, model):
        self.num_updates += 1
        n = self.num_updates
        one_minus = 1.0 - min(self.decay, (1.0 + n) / (10.0 + n))
        for name, p in self._tracked(model):
            s = self.shadow[name]
            s.sub_(one_minus * (s - p))

    @contextlib.contextmanager
    def swapped(self, model):
        """Within the block the tracked parameters hold the shadow."""
        saved = {}
        with torch.no_grad():
            for name, p in self._tracked(model):
                saved[name] = p.detach().clone()
                p.copy_(self.shadow[name])
        try:
            yield model
        finally:
            with torch.no_grad():
                for name, p in self._tracked(model):
                    p.copy_(saved[name])

    def state_dict(self):
        return {"shadow": self.shadow, "num_updates": self.num_updates}

    def load_state_dict(self, state):
        for name, s in state["shadow"].items():
            self.shadow[name].copy_(s)
        self.num_updates = state["num_updates"]
