"""Optimizer and LR schedule (mirrors the JAX package's training/optim.py:
75-191, the `optimizer="adam"` chain).

`torch.optim.Adam` computes optax.adam's update (eps 1e-8, eps_root 0,
bias correction by the post-increment count); the tests pin the two
against each other. The rest of optax's chain is written out here:

- `cosine_warmup_schedule`: linear warmup min_lr -> max_lr, then one
  cosine decay to min_lr; optax evaluates it at the pre-increment count,
  so the first update uses schedule(0);
- per-group max LRs: a parameter whose name starts with a prefix of
  `lr_groups` (`{"dm_decoder": dec_lr}`) follows that group's schedule;
- `clip_by_global_norm`: optax's rule, scale by `clip / max(norm, clip)`
  (no `+1e-6` as in `clip_grad_norm_`), on the device without a branch;
- gradient accumulation (optax.MultiSteps): the mean of k micro-batch
  gradients, one Adam update, LR tick and EMA tick per k micro-steps.
"""

import math

import torch


def cosine_warmup_schedule(max_lr, total_steps, warmup_steps, min_lr=0.0):
    """step -> lr (a Python float), the JAX package's schedule."""
    total_steps = max(int(total_steps), 1)
    warmup_steps = int(warmup_steps)

    def schedule(step):
        step = float(step)
        if step < warmup_steps:
            return min_lr + (max_lr - min_lr) * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (max_lr - min_lr) * (
            1.0 + math.cos(math.pi * progress))

    return schedule


def global_norm(tensors):
    """sqrt of the sum of squares of every element (f32 accumulation)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(tensors, max_norm):
    """Scale `tensors` in place by optax's rule; returns the norm before
    clipping (a 0-dim tensor)."""
    norm = global_norm(tensors)
    torch._foreach_mul_(tensors, max_norm / torch.clamp(norm, min=max_norm))
    return norm


class Optimizer:
    """Adam over `named_params` with per-group cosine-warmup LRs, optional
    global-norm clipping and k-step gradient accumulation.

    Call `backward_scale()` for the factor of each micro-batch's loss (the
    mean of k gradients), then `step()` after every micro-batch's
    backward: it updates the parameters on every k-th call and returns
    whether it did, with the pre-clip gradient norm of that update."""

    def __init__(self, named_params, lr, total_steps, warmup_steps,
                 min_lr=0.0, clip_grad=None, grad_accum_steps=1,
                 lr_groups=None):
        named_params = [(n, p) for n, p in named_params if p.requires_grad]
        prefixes = list(lr_groups or {})
        groups = {None: []}
        groups.update({prefix: [] for prefix in prefixes})
        for name, p in named_params:
            owner = next((pre for pre in prefixes
                          if name == pre or name.startswith(pre + ".")),
                         None)
            groups[owner].append(p)
        max_lrs = {None: lr, **(lr_groups or {})}
        self.schedules = []
        param_groups = []
        for key, params in groups.items():
            if params:
                self.schedules.append(cosine_warmup_schedule(
                    max_lrs[key], total_steps, warmup_steps, min_lr))
                param_groups.append({"params": params, "lr": 0.0})
        self.params = [p for _, p in named_params]
        self.adam = torch.optim.Adam(param_groups, betas=(0.9, 0.999),
                                     eps=1e-8)
        self.clip_grad = clip_grad if clip_grad and clip_grad > 0 else None
        self.k = max(int(grad_accum_steps), 1)
        self.micro = 0  # micro-batches since the last update
        self.count = 0  # optimizer updates so far (optax's count)

    def backward_scale(self):
        return 1.0 / self.k

    @torch.no_grad()
    def step(self):
        self.micro += 1
        if self.micro < self.k:
            return False, None
        self.micro = 0
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        norm = clip_by_global_norm_(grads, self.clip_grad) \
            if self.clip_grad else global_norm(grads)
        for group, sched in zip(self.adam.param_groups, self.schedules):
            group["lr"] = sched(self.count)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.count += 1
        return True, norm

    def state_dict(self):
        """Adam's state, the counters and, between updates, the gradients
        accumulated so far (optax.MultiSteps keeps them in its state)."""
        return {"adam": self.adam.state_dict(), "micro": self.micro,
                "count": self.count,
                "acc": [p.grad for p in self.params] if self.micro else None}

    def load_state_dict(self, state):
        self.adam.load_state_dict(state["adam"])
        self.micro, self.count = state["micro"], state["count"]
        for p, g in zip(self.params, state["acc"] or [None] * len(
                self.params)):
            p.grad = None if g is None else g.to(p.device)
