"""Tensor-parallel and FSDP layouts of the port's models over the
(data, model) mesh (the counterpart of the JAX package's
parallel/tp.py:38-159).

The rule table is the JAX package's (`_RULES`, tp.py:38-53), written for
the port's names, which `convert.py`'s walks give each JAX leaf:

- the UNet's `transformer_blocks.i.attn{1,2}.to_{q,k,v}` column-parallel
  and `to_out.0` row-parallel (JAX `attn\\d+/to_[qkv]`, `to_out`);
- GEGLU's `ff.net.0.proj` column-parallel, kernel and bias (`GEGLU_0/
  Dense_0`), and the FeedForward's output `ff.net.2` row-parallel
  (`block\\d+/Dense_0`);
- the AR decoder's `tf_dec.blocks.i.{self_attn,encoder_decoder_attn}.
  proj_{q,k,v}` column-parallel and `proj_o` row-parallel, `ffn.0`
  column-parallel, kernel and bias (`ffn_fc1`), `ffn.2` row-parallel
  (`ffn_fc2`).

Each applies as `ColwiseParallel` / `RowwiseParallel` over the mesh's
"model" dim, a row-parallel bias replicated. A leaf whose sharded width
does not divide the TP size is replicated, never an error (tp.py:59-79).
Where the port must differ from GSPMD, which keeps the logical layout:

- GEGLU's fused projection computes `h, gate = proj(x).chunk(2)`: plain
  row blocks would hand rank 0 all of `h`. Its rows are permuted to
  `[h_0; gate_0; h_1; gate_1; ...]` before sharding, so rank r holds
  `[h_r; gate_r]` and the local chunk is right; `ShardingPlan.to_full`
  / `from_full` undo and redo the permutation, so checkpoints keep the
  single-process layout.
- Under TP q, k and v are local tensors, and an attention computes on
  heads / tp heads (`num_heads`, and the AR attention's `d_model`, are
  set to the local ones), so no DTensor reaches an `sdt::` operator. An
  attention whose head count does not divide the TP size keeps all its
  projections replicated (`ShardingPlan.replicated` names them), where
  the JAX rule, which needs the width alone to divide, shards them.

FSDP (`fsdp=True`) shards over "data" in the ZeRO-3 manner with FSDP2
`fully_shard` (parameters, optimizer state and the EMA shadow, which
follow their parameter's layout). It mirrors `fsdp_augment`
(tp.py:82-112): a leaf of at least 2^14 elements is sharded along the
largest dimension of its JAX layout (`training.optim.flax_layouts`) that
the data size divides and TP does not shard; the others are left out of
FSDP (`ignored_params`) and stay replicated, their gradients averaged
over "data" by `ShardingPlan.reduce_grads`.
"""

import re

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["RULES", "FSDP_MIN_SIZE", "ShardingPlan", "parallelize",
           "tp_styles", "fsdp_dims", "tp_param_count", "fsdp_param_count",
           "shard_dims"]

# (regex on the name of the Linear a rule shards, style)
RULES = (
    (re.compile(r"transformer_blocks\.\d+\.attn\d+\.to_[qkv]$"), "colwise"),
    (re.compile(r"transformer_blocks\.\d+\.attn\d+\.to_out\.0$"), "rowwise"),
    (re.compile(r"transformer_blocks\.\d+\.ff\.net\.0\.proj$"), "geglu"),
    (re.compile(r"transformer_blocks\.\d+\.ff\.net\.2$"), "rowwise"),
    (re.compile(r"tf_dec\.blocks\.\d+\.\w+\.proj_[qkv]$"), "colwise"),
    (re.compile(r"tf_dec\.blocks\.\d+\.\w+\.proj_o$"), "rowwise"),
    (re.compile(r"tf_dec\.blocks\.\d+\.ffn\.0$"), "colwise"),
    (re.compile(r"tf_dec\.blocks\.\d+\.ffn\.2$"), "rowwise"),
)
# the leaves each style shards, with the torch dimension
SHARDED = {"colwise": {"weight": 0, "bias": 0},
           "geglu": {"weight": 0, "bias": 0},
           "rowwise": {"weight": 1}}
FSDP_MIN_SIZE = 1 << 14


def _rule(name):
    return next((style for rx, style in RULES if rx.search(name)), None)


def _width(module, style):
    """The width a style shards: the output's (GEGLU: each half's) or the
    input's."""
    if style == "rowwise":
        return module.in_features
    return module.out_features // (2 if style == "geglu" else 1)


def _attention_owners(model):
    """{attention module name: its head count} of the modules whose
    projections the rules name."""
    return {name: m.num_heads for name, m in model.named_modules()
            if hasattr(m, "num_heads") and (hasattr(m, "to_q") or
                                            hasattr(m, "proj_q"))}


def tp_styles(model, tp):
    """-> ({Linear name: style} that TP `tp` shards, {Linear name: why it
    stays replicated where the JAX rule shards it})."""
    if tp <= 1:
        return {}, {}
    styles = {}
    for name, m in model.named_modules():
        style = _rule(name)
        if style and isinstance(m, nn.Linear) and \
                _width(m, style) % tp == 0:
            styles[name] = style
    replicated = {}
    for owner, heads in _attention_owners(model).items():
        if heads % tp == 0:
            continue
        for name in [n for n in styles if n.rsplit(".", 1)[0] == owner or
                     n.rsplit(".", 2)[0] == owner]:
            del styles[name]
            replicated[name] = (f"{heads} heads do not split over TP {tp} "
                                "(the JAX rule shards the width)")
    return styles, replicated


def fsdp_dims(model, data, tp_sharded=None, layouts=None):
    """{parameter name: the torch dimension FSDP shards over `data`},
    `fsdp_augment`'s choice: parameters of at least FSDP_MIN_SIZE
    elements, the largest JAX-layout dimension that `data` divides and
    TP does not shard (`tp_sharded`: {name: torch dim}); ties to the
    first. The others are absent."""
    from ..training.optim import flax_layouts, view_dims
    if data <= 1:
        return {}
    layouts = flax_layouts(model) if layouts is None else layouts
    tp_sharded = tp_sharded or {}
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if p.dim() == 0 or p.numel() < FSDP_MIN_SIZE:
            continue
        # the torch dimension of each dimension of the JAX leaf (a packed
        # layout's leaf taken as the tensor itself)
        perm = view_dims(layouts.get(name), len(shape)) or \
            tuple(range(len(shape)))
        best = None
        for j, d in enumerate(perm):
            if d != tp_sharded.get(name) and shape[d] % data == 0 and \
                    (best is None or shape[d] > shape[perm[best]]):
                best = j
        if best is not None:
            out[name] = perm[best]
    return out


def _tp_sharded(styles):
    """{parameter name: torch dim} the TP styles shard."""
    return {f"{mod}.{leaf}": dim for mod, style in styles.items()
            for leaf, dim in SHARDED[style].items()}


def tp_param_count(model, tp):
    """Parameter elements TP `tp` shards over "model" (the JAX
    `tp_param_count`)."""
    styles, _ = tp_styles(model, tp)
    sharded = _tp_sharded(styles)
    return sum(p.numel() for n, p in model.named_parameters()
               if n in sharded)


def fsdp_param_count(model, data, tp=1):
    """Parameter elements FSDP shards over "data" (the JAX
    `fsdp_param_count`)."""
    styles, _ = tp_styles(model, tp)
    dims = fsdp_dims(model, data, _tp_sharded(styles))
    return sum(p.numel() for n, p in model.named_parameters() if n in dims)


def geglu_perm(rows, tp):
    """The row order that hands rank r `[h_r; gate_r]` of a fused GEGLU
    projection with `rows` = 2 * width rows."""
    half, d = rows // 2, rows // 2 // tp
    return torch.cat([torch.cat([torch.arange(r * d, (r + 1) * d),
                                 torch.arange(half + r * d,
                                              half + (r + 1) * d)])
                      for r in range(tp)])


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def shard_dims(t):
    """{dim of `t`: (process group, shard count)} for each mesh dim over
    which the DTensor `t` is sharded; {} for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return {}
    mesh = t.device_mesh
    return {pl.dim: (mesh.get_group(i), mesh.size(i))
            for i, pl in enumerate(t.placements) if isinstance(pl, Shard)}


def _gather(local, mesh, placements):
    """The whole tensor of which `local` is this rank's block, laid out by
    `placements` on `mesh` in even shards: `all_gather` over each mesh
    dim that shards it (gloo takes CUDA tensors there, where DTensor's
    functional collectives fail)."""
    for i, pl in enumerate(placements):
        if pl.is_shard():
            parts = [torch.empty_like(local) for _ in range(mesh.size(i))]
            dist.all_gather(parts, local.contiguous(),
                            group=mesh.get_group(i))
            local = torch.cat(parts, dim=pl.dim)
    return local


def whole(t):
    """The whole tensor of the DTensor `t` (a collective; a plain tensor as
    it is)."""
    if not hasattr(t, "to_local"):
        return t
    return _gather(t.to_local(), t.device_mesh, t.placements)


def block(full, mesh, placements):
    """This rank's block (its own storage) of the whole tensor `full` laid
    out by `placements` on `mesh` in even shards; no collective."""
    cut = full
    for i, pl in enumerate(placements):
        if pl.is_shard():
            size = cut.shape[pl.dim] // mesh.size(i)
            cut = cut.narrow(pl.dim, mesh.get_local_rank(i) * size, size)
    return full if cut is full else cut.clone()


class _Losses(nn.Module):
    """`model.compute_losses` as a forward, for DDP, whose gradient hooks
    expect their module's forward to run."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.compute_losses(*args, **kwargs)


class ShardingPlan:
    """How `parallelize` laid a model out: `kind` ("ddp", "tp", "fsdp" or
    "tp+fsdp"), the mesh, the TP styles by Linear name, the Linears left
    replicated where the JAX rule shards (`replicated`), the row
    permutations of GEGLU leaves (`perms`), FSDP's dimension of each
    parameter it shards (`fsdp_dims`). `compute_losses` runs the model's
    losses through the wrapper the plan needs (DDP's forward)."""

    def __init__(self, model, mesh, fsdp=False):
        self.model, self.mesh = model, mesh
        self.data = mesh["data"].size()
        # FSDP over one data rank shards nothing
        self.fsdp = bool(fsdp) and self.data > 1
        self.tp = mesh["model"].size()
        self.kind = "+".join(k for k, on in (("tp", self.tp > 1),
                                             ("fsdp", self.fsdp)) if on) \
            or "ddp"
        self.styles, self.replicated = tp_styles(model, self.tp)
        self.perms = {}
        self.fsdp_dims = {}
        self.ddp = None
        # parameters whose gradients `reduce_grads` averages over "data"
        self.manual = []

    @property
    def shards_model(self):
        """Whether parameters are DTensors (TP or FSDP)."""
        return self.kind != "ddp"

    def compute_losses(self, *args, **kwargs):
        if self.ddp is not None:
            return self.ddp(*args, **kwargs)
        return self.model.compute_losses(*args, **kwargs)

    @torch.no_grad()
    def reduce_grads(self):
        """Average the gradients no wrapper reduces over "data": every
        parameter under TP without FSDP, FSDP's ignored ones. One
        all-reduce a dtype (`Optimizer.backward` calls it after each
        micro-step's backward)."""
        if self.data == 1 or not self.manual:
            return
        group = self.mesh["data"].get_group()
        grads = [_local(p.grad) for p in self.manual if p.grad is not None]
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for same in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in same])
            dist.all_reduce(flat, group=group)
            flat /= self.data
            for g, v in zip(same, torch._utils._unflatten_dense_tensors(
                    flat, same)):
                g.copy_(v)

    def data_mean(self, t):
        """The mean over "data" of `t` (plain or DTensor), a new
        tensor."""
        if self.data == 1:
            return t
        local = _local(t).clone()
        dist.all_reduce(local, group=self.mesh["data"].get_group())
        local /= self.data
        if not hasattr(t, "to_local"):
            return local
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, t.device_mesh, t.placements)

    def to_full(self, name, t):
        """`t` (a parameter, or a state tensor of its shape, of parameter
        `name`) as the whole tensor in the single-process layout; a
        collective for a DTensor."""
        full = whole(t)
        perm = self.perms.get(name)
        if perm is not None and tuple(full.shape[:1]) == (len(perm),):
            full = full[torch.argsort(perm).to(full.device)]
        return full

    def from_full(self, name, full, like):
        """The single-process tensor `full` in the layout of `like` (a
        DTensor is given its local shard)."""
        from torch.distributed.tensor import DTensor
        full = full.to(like.device, like.dtype)
        perm = self.perms.get(name)
        if perm is not None and tuple(full.shape[:1]) == (len(perm),):
            full = full[perm.to(full.device)]
        if not isinstance(like, DTensor):
            return full
        mesh, placements = like.device_mesh, like.placements
        return DTensor.from_local(block(full, mesh, placements), mesh,
                                  placements, run_check=False)

    def _placements(self, p, dims):
        """The placements of a tensor whose dimension k runs along `p`'s
        dimension dims[k] (None: along none), on `p`'s mesh."""
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(dims.index(pl.dim)) if isinstance(pl, Shard) and
                pl.dim in dims else Replicate() for pl in p.placements]

    def state_full(self, name, p, local, dims):
        """An optimizer state tensor of parameter `name` (`p`), this rank's
        local tensor whose dimension k runs along `p`'s dimension dims[k]
        (None: along none), as the whole tensor in the single-process
        layout; a collective where `p` is a DTensor."""
        from torch.distributed.tensor import DTensor
        if not isinstance(p, DTensor):
            return local
        full = _gather(local, p.device_mesh, self._placements(p, dims))
        perm = self.perms.get(name)
        if perm is not None and 0 in dims:
            full = full.index_select(dims.index(0),
                                     torch.argsort(perm).to(full.device))
        return full

    def state_local(self, name, p, full, dims):
        """`state_full`'s inverse: this rank's local tensor of the whole
        state tensor `full`."""
        from torch.distributed.tensor import DTensor
        if not isinstance(p, DTensor):
            return full
        perm = self.perms.get(name)
        if perm is not None and 0 in dims:
            full = full.index_select(dims.index(0), perm.to(full.device))
        return block(full, p.device_mesh, self._placements(p, dims))

    def copy_full_(self, name, target, full):
        """Write the single-process tensor `full` into `target` in
        place."""
        value = self.from_full(name, full, target)
        with torch.no_grad():
            _local(target).copy_(_local(value))

    def grad_norm_sq(self, tensors):
        """The global sum of squares of `tensors` (gradients, plain or
        DTensor): each shard's squares summed over the groups it is
        sharded over, a replicated tensor counted once."""
        total, pending = 0.0, {}
        for t in tensors:
            sq = (_local(t).float() ** 2).sum()
            groups = tuple(g for g, _ in shard_dims(t).values())
            if groups:
                pending[groups] = pending.get(groups, 0.0) + sq
            else:
                total = total + sq
        for groups, sq in pending.items():
            for group in groups:
                dist.all_reduce(sq, group=group)
            total = total + sq
        return torch.as_tensor(total, dtype=torch.float32)


def parallelize(model, mesh, fsdp=False):
    """Lay `model` (built and initialised the same on every rank) out
    over `mesh`: DDP over "data" when "model" is 1 and `fsdp` is off;
    else the TP plan over "model", then `fully_shard` over "data" with
    `fsdp`, or gradients averaged by `ShardingPlan.reduce_grads`. ->
    the `ShardingPlan`. The optimizer and the EMA are built after it, on
    the laid-out parameters."""
    plan = ShardingPlan(model, mesh, fsdp)
    device = next(model.parameters()).device
    if plan.kind == "ddp":
        from torch.nn.parallel import DistributedDataParallel
        plan.ddp = DistributedDataParallel(
            _Losses(model), device_ids=[device.index]
            if device.type == "cuda" else None,
            process_group=mesh["data"].get_group())
        return plan
    if plan.styles:
        from torch.distributed.tensor.parallel import (
            ColwiseParallel, RowwiseParallel, parallelize_module)
        modules = dict(model.named_modules())
        for name, style in plan.styles.items():
            if style == "geglu":
                lin = modules[name]
                perm = geglu_perm(lin.out_features, plan.tp)
                for leaf in ("weight", "bias"):
                    p = getattr(lin, leaf)
                    if p is not None:
                        p.data = p.data[perm.to(p.device)]
                        plan.perms[f"{name}.{leaf}"] = perm
        owners = _attention_owners(model)
        for owner in owners:
            m = modules[owner]
            projs = [f"{owner}.{k}" for k in ("to_q", "proj_q")]
            if any(n in plan.styles for n in projs):
                m.num_heads //= plan.tp
                if hasattr(m, "d_model"):
                    m.d_model //= plan.tp
        parallelize_module(model, mesh["model"], {
            name: RowwiseParallel() if style == "rowwise"
            else ColwiseParallel() for name, style in plan.styles.items()})
    if plan.fsdp:
        from torch.distributed.fsdp import fully_shard, \
            register_fsdp_forward_method
        from torch.distributed.tensor import Shard
        dims = fsdp_dims(model, plan.data, _tp_sharded(plan.styles))
        plan.fsdp_dims = dims
        by_id = {id(p): dims.get(n) for n, p in model.named_parameters()}
        # in the model's order: every rank flattens them alike
        ignored = [p for n, p in model.named_parameters() if n not in dims]
        fully_shard(model, mesh=mesh["data"], ignored_params=set(ignored),
                    shard_placement_fn=lambda p: Shard(by_id[id(p)]))
        register_fsdp_forward_method(model, "compute_losses")
        plan.manual = [p for p in ignored if p.requires_grad]
    else:
        plan.manual = [p for p in model.parameters() if p.requires_grad]
    return plan
