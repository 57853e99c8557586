"""Optimizer and LR schedule (mirrors the JAX package's training/optim.py:
26-191): every core its `build_optimizer` selects by name, inside the
same chain.

The cores (`core_name` picks one as `build_optimizer` does: the
lower-cased `optimizer`, and `adamw` whenever `weight_decay > 0`):

- `adam`: `torch.optim.Adam` computes optax.adam's update (eps 1e-8,
  eps_root 0, bias correction by the post-increment count);
- `adam_fused`: the same update (the JAX `fused_adam` emits optax.adam's
  update from one lambda a leaf), `torch.optim.Adam(fused=True)`;
- `adamw`: optax.adamw adds `weight_decay * p` to Adam's direction before
  the LR scale, on every parameter; `torch.optim.AdamW` decays `p` by
  `lr * weight_decay` before the Adam step, the same update but for the
  order of rounding;
- `adam_bf16`: optax.adam(mu_dtype=bfloat16), `AdamBF16` below;
- `adafactor`: optax.adafactor with the JAX package's settings,
  `Adafactor` below;
- `sgd`: optax.sgd(momentum=0.9), `torch.optim.SGD(momentum=0.9,
  dampening=0)`: the trace `g + 0.9 t`, whose first value is `g`.

The tests pin each against optax. The rest of optax's chain is written
out here:

- `cosine_warmup_schedule`: linear warmup min_lr -> max_lr, then one
  cosine decay to min_lr; optax evaluates it at the pre-increment count,
  so the first update uses schedule(0);
- per-group max LRs: a parameter whose name starts with a prefix of
  `lr_groups` (`{"dm_decoder": dec_lr}`) follows that group's schedule;
- `clip_by_global_norm`: optax's rule, scale by `clip / max(norm, clip)`
  (no `+1e-6` as in `clip_grad_norm_`), on the device without a branch;
- gradient accumulation (optax.MultiSteps): the mean of k micro-batch
  gradients, one Adam update, LR tick and EMA tick per k micro-steps;
- the norm the trainer logs: the global norm of each micro-batch's own,
  unscaled gradient, as the JAX trainer logs `optax.global_norm(grads)`
  on every micro-step (training/trainer.py:289-290, 310).

Across processes (`plan`, a `parallel.tp.ShardingPlan`): the global norm
sums each shard's squares over the groups it is sharded over and counts
a replicated gradient once; the clip scales each local shard. Under
accumulation the k - 1 micro-steps before an update run without the
gradient sync (DDP's `no_sync`, FSDP2's `set_requires_gradient_sync`),
so no micro-batch's own global gradient exists there: those micro-steps
log no norm, and an update logs the norm of the accumulated mean. Under
TP or FSDP the parameters are DTensors mixed with plain tensors, which
torch's foreach and fused paths refuse: `adam`, `adamw` and `sgd` run
their per-tensor loops, and `adam_fused`, `adam_bf16` and `adafactor`
raise (SHARDED_CORES).
"""

import contextlib
import math

import numpy as np
import torch
from torch import nn


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


def _local(t):
    """A DTensor's local shard (a view: writing it writes the DTensor);
    a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


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


CORES = ("adam", "adam_fused", "adamw", "adam_bf16", "adafactor", "sgd")
# the cores that take DTensor parameters (TP, FSDP)
SHARDED_CORES = ("adam", "adamw", "sgd")


def core_name(optimizer="adam", weight_decay=0.0):
    """The core the JAX `build_optimizer` builds for these settings
    (training/optim.py:144-170): `adamw` whenever `weight_decay > 0`,
    whatever the name; else the lower-cased name, which must be one of
    `CORES`."""
    name = str(optimizer or "adam").lower()
    if name == "adamw" or (weight_decay and weight_decay > 0):
        return "adamw"
    if name not in CORES:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return name


def _bf16(x):
    """A Python float as the bf16 it becomes when JAX multiplies it into a
    bf16 array (weak typing converts the constant first)."""
    return torch.tensor(x, dtype=torch.bfloat16)


class _BF16State(torch.optim.Optimizer):
    """A core that keeps the state entries `BF16` in bf16:
    `torch.optim.Optimizer.load_state_dict` casts every floating entry to
    its parameter's dtype, so they are cast back (exactly)."""
    BF16 = ()

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in self.BF16:
                if k in st:
                    st[k] = st[k].to(torch.bfloat16)


class AdamBF16(_BF16State):
    """optax.adam(mu_dtype=bfloat16): the first moment is stored in bf16,
    the second in f32. As in optax, the new moment is
    `(1 - b1) * g + b1 * mu` where `b1 * mu` rounds to bf16 (a bf16 `mu`
    times a weakly typed float stays bf16) before the f32 add; the update
    uses that f32 moment, and only the state is cast to bf16. (A jitted
    JAX step with XLA's excess precision on, its default, keeps that
    product in f32; the port rounds where optax's program says, as its
    bf16 layers do.)"""
    BF16 = ("mu",)

    def __init__(self, params, lr=0.0, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2, eps, lr = (group[k] for k in ("b1", "b2", "eps", "lr"))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                if not state:
                    state["step"] = torch.zeros(())
                    state["mu"] = torch.zeros_like(
                        p, dtype=torch.bfloat16,
                        memory_format=torch.preserve_format)
                    state["nu"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                state["step"] += 1
                count = int(state["step"])
                mu = (g * (1 - b1)).add_(
                    state["mu"] * _bf16(b1).to(g.device))
                nu = state["nu"].mul_(b2).add_(g * g * (1 - b2))
                # optax corrects in f32: 1 - b ** count with b rounded
                # to f32 (for b2 = 0.999 that moves the factor by ~1e-5)
                c1, c2 = (float(1 - torch.tensor(b) ** count)
                          for b in (b1, b2))
                p.add_((mu / c1).div_((nu / c2).sqrt_().add_(eps))
                       .mul_(-lr))
                state["mu"].copy_(mu)


def _factored_dims(shape, min_dim_size_to_factor):
    """optax's rule (factorized.py:_factored_dims): the two largest
    dimensions (d1 the second, d0 the largest, ties in index order), or
    None where the second is below `min_dim_size_to_factor`."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def flax_views(t, layout):
    """Views of the port's tensor `t` in the layout of the JAX package's
    leaves it holds, for `layout` (a `flax_layouts` entry; None: the
    same layout): `dense` [out, in] -> [in, out]; `conv` [F, C, kh, kw]
    -> [kh, kw, C, F]; `deconv` [C, F, kh, kw] -> [kh, kw, C, F] (the
    flip permutes within dimensions); `("qkv", heads)`, the packed
    in-projection [3D, D] -> three [D, heads, D / heads];
    `("qkv_bias", heads)` -> three [heads, D / heads]; `("attn_out",
    heads)` [D, D] -> [heads, D / heads, D]; `("gates", n)`, an LSTM's
    [n H, in] -> n of [in, H]. Writing a view writes `t`."""
    kind, n = layout if isinstance(layout, tuple) else (layout, 0)
    if kind == "dense":
        return [t.t()]
    if kind == "conv":
        return [t.permute(2, 3, 1, 0)]
    if kind == "deconv":
        return [t.permute(2, 3, 0, 1)]
    if kind == "qkv":
        return [c.t().view(c.shape[1], n, -1) for c in t.chunk(3)]
    if kind == "qkv_bias":
        return [c.view(n, -1) for c in t.chunk(3)]
    if kind == "attn_out":
        return [t.t().view(n, -1, t.shape[0])]
    if kind == "gates":
        return [c.t() for c in t.chunk(n)]
    return [t]


def flax_layouts(model):
    """{parameter name: layout} of `model`'s tensors whose layout differs
    from the JAX package's leaf (`flax_views`): convolutions, transposed
    convolutions, dense kernels (`Linear`, GRU cells), LSTM gates and the
    packed attention projections of the transformer layers."""
    out = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, nn.ConvTranspose2d):
            out[f"{pre}weight"] = "deconv"
        elif isinstance(m, nn.Conv2d):
            out[f"{pre}weight"] = "conv"
        elif isinstance(m, nn.Linear):
            out[f"{pre}weight"] = "dense"
        elif isinstance(m, nn.GRUCell):
            out.update({f"{pre}weight_ih": "dense",
                        f"{pre}weight_hh": "dense"})
        elif isinstance(m, nn.LSTM):
            out.update({f"{pre}{k}": ("gates", 4)
                        for k, _ in m.named_parameters()
                        if k.startswith("weight_")})
    for name, m in model.named_modules():
        if hasattr(m, "in_proj_weight") and hasattr(m, "num_heads"):
            h = m.num_heads
            out.update({f"{name}.in_proj_weight": ("qkv", h),
                        f"{name}.in_proj_bias": ("qkv_bias", h),
                        f"{name}.out_proj.weight": ("attn_out", h)})
    return out


class Adafactor(_BF16State):
    """optax.adafactor as the JAX package builds it (training/optim.py:
    158-166: min_dim_size_to_factor 128, no parameter scale, no clipping,
    momentum 0.9 kept in bf16), optax 0.2.6's chain in its order:

    1. scale_by_factored_rms: decay `1 - (t + 1)^-0.8` (t the count
       before this update), eps 1e-30 added to g^2; where the two
       largest dimensions of the JAX leaf are both at least 128, the row
       and column means of g^2 (over the largest and the second largest)
       are kept instead of g^2, and the update is
       `g (v_row / mean(v_row))^-1/2 v_col^-1/2`; else `g v^-1/2`;
    2. the LR scale;
    3. the ema of the scaled update, `(1 - 0.9) u + 0.9 m` with `0.9 m`
       rounded to bf16 as in `AdamBF16`, not debiased; `m` is stored in
       bf16;
    4. the sign flip.

    The dimensions follow the JAX leaf's layout: `layouts` maps a
    parameter to its `flax_views` layout, and the statistics are kept per
    view."""
    BF16 = ("m",)

    def __init__(self, params, lr=0.0, layouts=None, momentum=0.9,
                 decay_rate=0.8, eps=1e-30, min_dim_size_to_factor=128):
        super().__init__(params, dict(lr=lr))
        self.layouts = dict(layouts or {})
        self.momentum = momentum
        self.decay_rate = decay_rate
        self.eps = eps
        self.min_dim = min_dim_size_to_factor

    def _init_state(self, p, state):
        state["step"] = torch.zeros(())
        state["m"] = torch.zeros_like(p, dtype=torch.bfloat16,
                                      memory_format=torch.preserve_format)
        for i, v in enumerate(flax_views(p, self.layouts.get(p))):
            dims = _factored_dims(tuple(v.shape), self.min_dim)
            if dims is None:
                state[f"v{i}"] = torch.zeros(v.shape, device=p.device)
            else:
                d1, d0 = dims
                shape = list(v.shape)
                state[f"v_row{i}"] = torch.zeros(
                    shape[:d0] + shape[d0 + 1:], device=p.device)
                state[f"v_col{i}"] = torch.zeros(
                    shape[:d1] + shape[d1 + 1:], device=p.device)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    self._init_state(p, state)
                # the decay in f32, from the count before this update
                t = state["step"].float() + 1
                decay = float(1 - t ** -self.decay_rate)
                rest = float(1 - torch.tensor(decay))
                state["step"] += 1
                u = torch.empty_like(p)
                layout = self.layouts.get(p)
                for i, (g, out) in enumerate(zip(
                        flax_views(p.grad, layout), flax_views(u, layout))):
                    g2 = g * g + self.eps
                    dims = _factored_dims(tuple(g.shape), self.min_dim)
                    if dims is None:
                        v = state[f"v{i}"].mul_(decay).add_(g2 * rest)
                        out.copy_(g * v ** -0.5)
                        continue
                    d1, d0 = dims
                    row = state[f"v_row{i}"].mul_(decay).add_(
                        g2.mean(d0) * rest)
                    col = state[f"v_col{i}"].mul_(decay).add_(
                        g2.mean(d1) * rest)
                    mean = row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
                    out.copy_(g * ((row / mean) ** -0.5).unsqueeze(d0)
                              * (col ** -0.5).unsqueeze(d1))
                u.mul_(group["lr"])
                m = u.mul_(1 - self.momentum).add_(
                    state["m"] * _bf16(self.momentum).to(p.device))
                state["m"].copy_(m)
                p.sub_(m)


def build_core(name, param_groups, weight_decay=0.0, layouts=None,
               sharded=False):
    """The torch optimizer of the core `name` (`core_name`) over
    `param_groups`; `layouts` ({parameter: layout}) for adafactor.
    `sharded`: some parameters are DTensors (the per-tensor loops; a core
    outside SHARDED_CORES raises)."""
    if sharded and name not in SHARDED_CORES:
        raise ValueError(f"the {name} optimizer does not take TP or FSDP "
                         f"yet: use one of {SHARDED_CORES}, or data "
                         "parallelism alone")
    loop = dict(foreach=False) if sharded else {}
    if name in ("adam", "adam_fused"):
        return torch.optim.Adam(param_groups, betas=(0.9, 0.999), eps=1e-8,
                                fused=True if name == "adam_fused" else None,
                                **loop)
    if name == "adamw":
        return torch.optim.AdamW(param_groups, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay or 0.0,
                                 **loop)
    if name == "adam_bf16":
        return AdamBF16(param_groups)
    if name == "adafactor":
        return Adafactor(param_groups, layouts=layouts)
    return torch.optim.SGD(param_groups, lr=0.0, momentum=0.9,
                           dampening=0.0, **loop)


class Optimizer:
    """The core `core_name(optimizer, weight_decay)` names over
    `named_params`, with per-group cosine-warmup LRs, optional
    global-norm clipping and k-step gradient accumulation. `layouts`
    ({name: layout}, `flax_layouts` of the model) tells adafactor the
    JAX layout of each tensor.

    Call `backward(loss)` for each micro-batch (or backward its loss
    times `backward_scale()`, the factor of the mean of k gradients), then
    `step()`: it updates the parameters on every k-th call and returns
    whether it did, with the pre-clip gradient norm of that update.
    `plan` (a `parallel.tp.ShardingPlan`): the parameters are laid out
    across processes by it."""

    def __init__(self, named_params, lr, total_steps, warmup_steps,
                 min_lr=0.0, clip_grad=None, grad_accum_steps=1,
                 lr_groups=None, optimizer="adam", weight_decay=0.0,
                 layouts=None, plan=None):
        self.name = core_name(optimizer, weight_decay)
        named_params = [(n, p) for n, p in named_params if p.requires_grad]
        prefixes = list(lr_groups or {})
        groups = {None: []}
        groups.update({prefix: [] for prefix in prefixes})
        for name, p in named_params:
            owner = next((pre for pre in prefixes
                          if name == pre or name.startswith(pre + ".")),
                         None)
            groups[owner].append((name, p))
        max_lrs = {None: lr, **(lr_groups or {})}
        self.schedules = []
        param_groups = []
        for key, params in groups.items():
            if params:
                self.schedules.append(cosine_warmup_schedule(
                    max_lrs[key], total_steps, warmup_steps, min_lr))
                param_groups.append({"params": [p for _, p in params],
                                     "lr": 0.0})
        # the core's state is keyed by the index in group order
        self.core_names = [n for params in groups.values() for n, _ in params]
        self.params = [p for _, p in named_params]
        by_name = dict(named_params)
        self.plan = plan
        self.core = build_core(self.name, param_groups, weight_decay, {
            by_name[n]: v for n, v in (layouts or {}).items()
            if n in by_name}, sharded=plan is not None and plan.shards_model)
        self.names = [n for n, _ in named_params]
        self.clip_grad = clip_grad if clip_grad and clip_grad > 0 else None
        self.k = max(int(grad_accum_steps), 1)
        self.micro = 0  # micro-batches since the last update
        self.count = 0  # optimizer updates so far (optax's count)

    @property
    def lr(self):
        """The LR of the first group's last update."""
        return self.core.param_groups[0]["lr"]

    def state_bytes(self):
        """Bytes of the core's state tensors (moments, factors, traces)."""
        return sum(v.numel() * v.element_size()
                   for st in self.core.state.values() for v in st.values()
                   if torch.is_tensor(v))

    def backward_scale(self):
        return 1.0 / self.k

    def sync_context(self):
        """The context of a micro-step's forward and backward: under a plan
        the gradient sync is off on the k - 1 micro-steps before an
        update (`ShardingPlan.sync_context`)."""
        if self.plan is None:
            return contextlib.nullcontext()
        return self.plan.sync_context(self.micro + 1 == self.k)

    def backward(self, loss):
        """Backward of one micro-batch's `loss` into the accumulated
        gradients; -> the global norm of this micro-batch's own unscaled
        gradient (a 0-dim tensor) when k > 1, else None (at k = 1 that norm
        is the one `step()` takes). For k > 1 the accumulated gradients are
        held aside during the backward and added back after it: the sums
        are the ones autograd would form, and the norm is taken from the
        micro-batch's gradient alone."""
        if self.plan is not None:
            (loss * self.backward_scale()).backward()
            return None
        if self.k == 1:
            loss.backward()
            return None
        held = [p.grad for p in self.params]
        for p in self.params:
            p.grad = None
        (loss * self.backward_scale()).backward()
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = self.k * global_norm(grads) if grads else \
            torch.zeros((), device=loss.device)
        with torch.no_grad():
            for p, g in zip(self.params, held):
                if g is not None:
                    p.grad = g if p.grad is None else g.add_(p.grad)
        return norm

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
        if self.plan is not None:
            self.plan.reduce_grads()
            norm = self.plan.grad_norm_sq(grads).sqrt()
            if self.clip_grad:
                torch._foreach_mul_(
                    [_local(g) for g in grads],
                    self.clip_grad / torch.clamp(norm, min=self.clip_grad))
        else:
            norm = clip_by_global_norm_(grads, self.clip_grad) \
                if self.clip_grad else global_norm(grads)
        for group, sched in zip(self.core.param_groups, self.schedules):
            group["lr"] = sched(self.count)
        self.core.step()
        self.core.zero_grad(set_to_none=True)
        self.count += 1
        return True, norm

    def state_dict(self):
        """The core's name and state, the counters and, between updates,
        the gradients accumulated so far (optax.MultiSteps keeps them in
        its state). Under a plan every tensor is whole, in the
        single-process layout (a collective: every rank calls it), and
        the accumulated gradients are the mean over "data" of each rank's
        (what the next sync would average them into)."""
        core = self.core.state_dict()
        acc = [p.grad for p in self.params] if self.micro else None
        if self.plan is None:
            return {"name": self.name, "core": core, "micro": self.micro,
                    "count": self.count, "acc": acc}
        if acc is not None and self.plan.fsdp and self.plan.data > 1:
            raise ValueError("under FSDP a checkpoint is written only "
                             "between updates, not between the micro-steps "
                             "of one (grad_accum_steps)")
        core["state"] = {i: {k: self.plan.to_full(self.core_names[i], v)
                             if torch.is_tensor(v) and v.dim() else v
                             for k, v in st.items()}
                         for i, st in core["state"].items()}
        if acc is not None:
            acc = [None if g is None else self.plan.to_full(
                n, self.plan.data_mean(g)) for n, g in zip(self.names, acc)]
        return {"name": self.name, "core": core, "micro": self.micro,
                "count": self.count, "acc": acc}

    def load_state_dict(self, state):
        """Load `state_dict()`'s dict, or one written before the other
        cores (Adam's state under "adam"); under a plan, into the plan's
        layout."""
        name = state.get("name", "adam")
        if name != self.name:
            raise ValueError(f"the state is {name}'s, this optimizer is "
                             f"{self.name}")
        self.core.load_state_dict(state["core"] if "core" in state
                                  else state["adam"])
        self.micro, self.count = state["micro"], state["count"]
        if self.plan is not None:
            by_index = [p for g in self.core.param_groups
                        for p in g["params"]]
            for i, p in enumerate(by_index):
                st = self.core.state.get(p, {})
                for k, v in st.items():
                    if torch.is_tensor(v) and v.dim():
                        st[k] = self.plan.from_full(self.core_names[i], v, p)
        for n, p, g in zip(self.names, self.params, state["acc"] or [None] *
                           len(self.params)):
            if g is None:
                p.grad = None
            elif self.plan is None:
                p.grad = g.to(p.device)
            else:
                p.grad = self.plan.from_full(n, g, p)
