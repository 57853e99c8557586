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
a replicated gradient once; the clip scales each local shard. Every
micro-step's gradient is averaged over "data" in its own backward (DDP's
all-reduce, FSDP2's reduce-scatter, `ShardingPlan.reduce_grads` for the
rest), with the sums held so far set aside: each micro-step logs the
norm of its own global gradient as one process does, and the sums held
are the mean over "data" of each rank's, laid out as the parameters (a
checkpoint between micro-steps writes them whole; under FSDP they stay
sharded, where FSDP2's switched-off sync would keep a whole unsharded
gradient on every rank, and a copy's all-reduce for the norm would move
twice the bytes of the reduce-scatter). Under TP or FSDP the parameters
are DTensors mixed with plain tensors: every core steps on the local
shards (`_on_local_shards`: torch's foreach and fused paths over plain
tensors, the elementwise updates of `adam_bf16`), and adafactor takes
the row and column sums of a factored dimension that is sharded over
the shard group before it divides, so each rank holds the statistics
one process would. The optimizer state is kept as local tensors;
`Optimizer.state_dict` writes it whole in the single-process layout
(`ShardingPlan.state_full`, along the dimensions `Adafactor.state_dims`
names).
"""

import contextlib
import math

import numpy as np
import torch
from torch import nn

from ..parallel.tp import block, shard_dims, whole


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


def _mean(x, dim, n, group=None, keepdim=False):
    """The mean of `x` over `dim`, whose whole size is `n`: where `dim` is
    sharded over `group`, the partial sums are added over it first."""
    if group is None:
        return x.mean(dim, keepdim=keepdim)
    s = x.sum(dim, keepdim=keepdim)
    torch.distributed.all_reduce(s, group=group)
    return s / n


@contextlib.contextmanager
def _on_local_shards(core):
    """Within the block the parameters of `core` (a torch optimizer) are
    the local shards of its DTensor parameters, plain tensors whose
    gradients are the local gradients, and its state is keyed by them:
    torch's foreach and fused paths, which refuse DTensors mixed with
    plain tensors, then run on plain tensors, and an elementwise update
    of the shards is the update of the whole. The state is kept under the
    DTensor parameter, as local tensors."""
    groups, swaps = [g["params"] for g in core.param_groups], []
    with torch.no_grad():
        for group in core.param_groups:
            local = []
            for p in group["params"]:
                if hasattr(p, "to_local"):
                    lp = p.to_local()
                    lp.grad = None if p.grad is None else _local(p.grad)
                    if p in core.state:
                        core.state[lp] = core.state.pop(p)
                    swaps.append((p, lp))
                    p = lp
                local.append(p)
            group["params"] = local
    try:
        yield core
    finally:
        for group, params in zip(core.param_groups, groups):
            group["params"] = params
        for p, lp in swaps:
            if lp in core.state:
                core.state[p] = core.state.pop(lp)
            lp.grad = None


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


# the JAX leaf's dimension j is the torch tensor's dimension PERMS[j]
# (`flax_views`)
PERMS = {"dense": (1, 0), "conv": (2, 3, 1, 0), "deconv": (2, 3, 0, 1)}


def view_dims(layout, ndim):
    """For each dimension of the `flax_views` view of an `ndim`-dim tensor
    in `layout`, the tensor's dimension it runs along; None for the
    packed layouts, whose views split or join the tensor's dimensions."""
    if isinstance(layout, tuple):
        return None
    perm = PERMS.get(layout)
    return perm if perm and len(perm) == ndim else tuple(range(ndim))


def adafactor_stats(shape, layout, sharded=None, min_dim_size_to_factor=128):
    """The statistics `Adafactor` keeps for a parameter of (whole) `shape`
    in `layout`, sharded over the counts `sharded` ({dim: count}):
    [(state key, local shape, dims)], `dims` naming for each dimension of
    the statistic the parameter's dimension it runs along (None: none of
    them, or a packed layout's). A packed layout's sharded parameter
    keeps them whole (its step gathers the gradient)."""
    sharded = sharded or {}
    meta = torch.empty(shape, device="meta")
    gathered = bool(sharded) and isinstance(layout, tuple)
    out = []
    for i, v in enumerate(flax_views(meta, layout)):
        vshape = tuple(v.shape)
        vdims = view_dims(layout, len(shape))
        vdims = (None,) * len(vshape) if vdims is None or gathered else vdims
        fd = _factored_dims(vshape, min_dim_size_to_factor)
        stats = [(f"v{i}", None)] if fd is None else \
            [(f"v_row{i}", fd[1]), (f"v_col{i}", fd[0])]
        for key, drop in stats:
            keep = [j for j in range(len(vshape)) if j != drop]
            dims = tuple(vdims[j] for j in keep)
            local = tuple(vshape[j] // (1 if d is None else
                                        sharded.get(d, 1))
                          for j, d in zip(keep, dims))
            out.append((key, local, dims))
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
    view. A DTensor parameter (TP, FSDP) steps on its local shard, its
    state local tensors (`adafactor_stats`): a mean over a sharded
    dimension adds the partial sums over the shard group before it
    divides by the whole size, so every rank holds the statistics one
    process would; a packed layout's sharded parameter gathers its
    gradient and updates the whole, keeping its shard."""
    BF16 = ("m",)

    def __init__(self, params, lr=0.0, layouts=None, momentum=0.9,
                 decay_rate=0.8, eps=1e-30, min_dim_size_to_factor=128):
        super().__init__(params, dict(lr=lr))
        self.layouts = dict(layouts or {})
        self.momentum = momentum
        self.decay_rate = decay_rate
        self.eps = eps
        self.min_dim = min_dim_size_to_factor

    def _stats(self, p):
        return adafactor_stats(tuple(p.shape), self.layouts.get(p),
                               {d: n for d, (_, n) in shard_dims(p).items()},
                               self.min_dim)

    def state_dims(self, p, key):
        """For each dimension of state `key`'s whole tensor, the dimension
        of `p` it runs along (or None)."""
        if key == "m":
            return tuple(range(p.dim()))
        return next(dims for k, _, dims in self._stats(p) if k == key)

    def _init_state(self, p, state):
        local = _local(p)
        state["step"] = torch.zeros(())
        state["m"] = torch.zeros_like(local, dtype=torch.bfloat16,
                                      memory_format=torch.preserve_format)
        for key, shape, _ in self._stats(p):
            state[key] = torch.zeros(shape, device=local.device)

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
                layout, shards = self.layouts.get(p), shard_dims(p)
                local = _local(p)
                if shards and isinstance(layout, tuple):
                    # a packed layout's views cut across the shards: the
                    # update of the whole, then this rank's block of it
                    u = block(self._update(whole(p.grad), layout, {}, state,
                                           decay, rest),
                              p.device_mesh, p.placements)
                else:
                    u = self._update(_local(p.grad), layout, shards, state,
                                     decay, rest)
                u.mul_(group["lr"])
                m = u.mul_(1 - self.momentum).add_(
                    state["m"] * _bf16(self.momentum).to(local.device))
                state["m"].copy_(m)
                local.sub_(m)

    def _update(self, grad, layout, shards, state, decay, rest):
        """The scaled update `g v^-1/2` (or its factored form) of the
        gradient `grad`, this rank's local tensor of a parameter sharded
        over `shards` ({dim: (group, count)}), its statistics in `state`
        updated in place."""
        u = torch.empty_like(grad)
        whole = list(grad.shape)
        for d, (_, n) in shards.items():
            whole[d] *= n
        wviews = flax_views(torch.empty(whole, device="meta"), layout)
        vdims = view_dims(layout, grad.dim())
        for i, (g, out, wv) in enumerate(zip(
                flax_views(grad, layout), flax_views(u, layout), wviews)):
            g2 = g * g + self.eps
            dims = _factored_dims(tuple(wv.shape), self.min_dim)
            if dims is None:
                v = state[f"v{i}"].mul_(decay).add_(g2 * rest)
                out.copy_(g * v ** -0.5)
                continue
            d1, d0 = dims

            def group_of(j):
                return shards.get(vdims[j], (None,))[0] if vdims else None

            row = state[f"v_row{i}"].mul_(decay).add_(
                _mean(g2, d0, wv.shape[d0], group_of(d0)) * rest)
            col = state[f"v_col{i}"].mul_(decay).add_(
                _mean(g2, d1, wv.shape[d1], group_of(d1)) * rest)
            mean = _mean(row, d1 - 1 if d1 > d0 else d1, wv.shape[d1],
                         group_of(d1), keepdim=True)
            out.copy_(g * ((row / mean) ** -0.5).unsqueeze(d0)
                      * (col ** -0.5).unsqueeze(d1))
        return u


def build_core(name, param_groups, weight_decay=0.0, layouts=None):
    """The torch optimizer of the core `name` (`core_name`) over
    `param_groups`; `layouts` ({parameter: layout}) for adafactor."""
    if name in ("adam", "adam_fused"):
        return torch.optim.Adam(param_groups, betas=(0.9, 0.999), eps=1e-8,
                                fused=True if name == "adam_fused" else None)
    if name == "adamw":
        return torch.optim.AdamW(param_groups, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay or 0.0)
    if name == "adam_bf16":
        return AdamBF16(param_groups)
    if name == "adafactor":
        return Adafactor(param_groups, layouts=layouts)
    return torch.optim.SGD(param_groups, lr=0.0, momentum=0.9,
                           dampening=0.0)


def state_shapes(name, shape, layout=None, sharded=None):
    """The state `build_core(name, ...)` keeps for a trainable parameter
    of (whole) `shape` in `layout` (adafactor's), sharded over the counts
    `sharded` ({dim: count}): [(state key, local shape, dtype, whether
    it lives on the parameter's device)]. The step count is a host
    scalar but for the fused Adam's, which its kernel reads."""
    sharded = dict(sharded or {})
    local = tuple(s // sharded.get(d, 1) for d, s in enumerate(shape))
    f32, bf16 = torch.float32, torch.bfloat16
    if name == "sgd":
        return [("momentum_buffer", local, f32, True)]
    step = [("step", (), f32, name == "adam_fused")]
    if name == "adam_bf16":
        return step + [("mu", local, bf16, True), ("nu", local, f32, True)]
    if name == "adafactor":
        return step + [("m", local, bf16, True)] + [
            (k, s, f32, True)
            for k, s, _ in adafactor_stats(shape, layout, sharded)]
    return step + [("exp_avg", local, f32, True),
                   ("exp_avg_sq", local, f32, True)]


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
    across processes by it, and `backward` is the only way in (it
    averages each micro-step's gradient over "data")."""

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
            if n in by_name})
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
        """Bytes of the core's state tensors (moments, factors, traces);
        under a plan, this rank's local tensors."""
        return sum(v.numel() * v.element_size()
                   for st in self.core.state.values() for v in st.values()
                   if torch.is_tensor(v))

    def backward_scale(self):
        return 1.0 / self.k

    def backward(self, loss):
        """Backward of one micro-batch's `loss` into the accumulated
        gradients; -> the global norm of this micro-batch's own unscaled
        gradient (a 0-dim tensor) when k > 1, else None (at k = 1 that norm
        is the one `step()` takes). For k > 1 the accumulated gradients are
        held aside during the backward and added back after it: the sums
        are the ones autograd would form, and the norm is taken from the
        micro-batch's gradient alone. Under a plan that gradient is
        averaged over "data" first (the plan's wrappers in the backward,
        then `reduce_grads`), so the norm is the global micro-batch's and
        the sums are the same on every data rank."""
        held = [p.grad for p in self.params] if self.k > 1 else []
        for p in self.params if held else ():
            p.grad = None
        (loss * self.backward_scale()).backward()
        if self.plan is not None:
            self.plan.reduce_grads()
        if not held:
            return None
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.plan is not None:
            norm = self.k * self.plan.grad_norm_sq(grads).sqrt()
        else:
            norm = self.k * global_norm(grads) if grads else \
                torch.zeros((), device=loss.device)
        with torch.no_grad():
            for p, g in zip(self.params, held):
                if g is not None:
                    if p.grad is not None:
                        _local(g).add_(_local(p.grad))
                    p.grad = g
        return norm

    def _state_dims(self, p, key):
        """For each dimension of the state tensor `key` of `p`, the
        dimension of `p` it runs along (the core's `state_dims`; else the
        parameter's own)."""
        if hasattr(self.core, "state_dims"):
            return self.core.state_dims(p, key)
        return tuple(range(p.dim()))

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
        with contextlib.nullcontext() if isinstance(self.core, Adafactor) \
                else _on_local_shards(self.core):
            self.core.step()
        self.core.zero_grad(set_to_none=True)
        self.count += 1
        return True, norm

    def state_dict(self):
        """The core's name and state, the counters and, between updates,
        the gradients accumulated so far (optax.MultiSteps keeps them in
        its state). Under a plan every tensor is whole, in the
        single-process layout (a collective: every rank calls it); the
        accumulated gradients are already the mean over "data" of each
        rank's sums (`backward`)."""
        core = self.core.state_dict()
        acc = [p.grad for p in self.params] if self.micro else None
        if self.plan is not None:
            by_index = [p for g in self.core.param_groups
                        for p in g["params"]]
            core["state"] = {i: {
                k: self.plan.state_full(self.core_names[i], by_index[i], v,
                                        self._state_dims(by_index[i], k))
                if torch.is_tensor(v) and v.dim() else v
                for k, v in st.items()} for i, st in core["state"].items()}
            if acc is not None:
                acc = [None if g is None else self.plan.to_full(n, g)
                       for n, g in zip(self.names, acc)]
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
                        st[k] = self.plan.state_local(
                            self.core_names[i], p, v, self._state_dims(p, k))
        for n, p, g in zip(self.names, self.params, state["acc"] or [None] *
                           len(self.params)):
            if g is None:
                p.grad = None
            elif self.plan is None:
                p.grad = g.to(p.device)
            else:
                p.grad = self.plan.from_full(n, g, p)
