"""Per-card memory of the training step under each plan (the counterpart
of the JAX package's parallel/aot.py:73-216, for NVIDIA cards).

The JAX module compiles the train step for TPU topologies that are not
attached and reads per-chip bytes off the executable. Here nothing is
compiled for a topology:

- the state bytes one card holds come from shard shapes: the model is
  built on `torch.device("meta")` and each parameter's local shape is
  its whole shape cut by the counts `parallel.tp` lays it out with (the
  TP styles, `fsdp_dims`); the optimizer state is each core's own
  layout (`training.optim.state_shapes`), the EMA and the parameters
  follow their layout, DDP's gradient buckets are one f32 copy of the
  trainable parameters (`state_bytes`);
- the activation peak is measured on one card: the most
  `torch.cuda.max_memory_allocated` rises over one training step at the
  plan's local batch above what the step starts with (`step_peak`;
  None on the CPU, never made up);
- `size_plan` adds the batch, the capacity of the card
  (`torch.cuda.get_device_properties(...).total_memory`, or 80 GiB for
  an H100 when sizing on a host without one) and a `fits` verdict;
  `format_table` prints the rows in the JAX table's columns.

The leaves the port keeps replicated where the JAX rule shards them
(`ShardingPlan.replicated`: attention projections whose head count does
not divide the TP size) are counted whole and named in each row.

`scripts/aot_scaling_torch.py` drives it; `docs/scaling_torch.md` holds
its table.
"""

import math

import torch

from .tp import _tp_sharded, fsdp_dims, tp_styles

# the capacity assumed when sizing on a host without the card
H100_BYTES = 80 * 2 ** 30


def plan_name(data, model=1, fsdp=False):
    """The JAX `_plan_name`: dp{data}, then xtp{model} and +fsdp."""
    name = f"dp{data}"
    if model > 1:
        name += f"xtp{model}"
    if fsdp:
        name += "+fsdp"
    return name


def layout(model, data, tp=1, fsdp=False):
    """-> ({parameter name: {dim: shard count}} of the plan, {Linear name:
    why it stays replicated where the JAX rule shards it}), as
    `parallelize` lays `model` out over data x tp cards."""
    styles, replicated = tp_styles(model, tp)
    sharded = _tp_sharded(styles)
    out = {n: {d: tp} for n, d in sharded.items()}
    if fsdp and data > 1:
        for n, d in fsdp_dims(model, data, sharded).items():
            out.setdefault(n, {})[d] = data
    return out, replicated


def _local_numel(shape, cuts):
    return math.prod(s // cuts.get(d, 1) for d, s in enumerate(shape))


def state_bytes(model, cfg, data, tp=1, fsdp=False, optimizer=None,
                ddp=None):
    """Bytes one card holds of the training state of `model` (built on
    any device, the meta one included) under data x tp cards (`fsdp`):
    {"params": parameters and buffers, "opt": the optimizer's state on
    the card (the config's core unless `optimizer` names one),
    "opt_host": its step counts kept on the host, "ema": the EMA shadow,
    "buckets": DDP's gradient buckets (the plan without TP and FSDP
    across processes; `ddp` says whether DDP wraps the model where that
    is not data > 1, as one rank of a process group),
    "replicated": the Linears kept whole where the JAX rule shards}."""
    from ..training.optim import core_name, flax_layouts, state_shapes
    cuts, replicated = layout(model, data, tp, fsdp)
    core = core_name(optimizer or getattr(cfg, "optimizer", "adam"),
                     getattr(cfg, "weight_decay", 0.0))
    frozen = {id(p) for m in model.frozen_modules for p in m.parameters()}
    use_ema = model.use_ema or getattr(cfg, "use_ema", False)
    layouts = flax_layouts(model) if core == "adafactor" else {}
    if ddp is None:
        ddp = data > 1 and tp == 1 and not fsdp
    out = dict(params=0, opt=0, opt_host=0, ema=0, buckets=0)
    for name, p in model.named_parameters():
        shape, c = tuple(p.shape), cuts.get(name, {})
        local = _local_numel(shape, c) * p.element_size()
        out["params"] += local
        if use_ema and name.startswith(model.ema_prefix):
            out["ema"] += local
        if id(p) in frozen:
            continue
        for _, s, dtype, on_card in state_shapes(core, shape,
                                                 layouts.get(name), c):
            out["opt" if on_card else "opt_host"] += \
                math.prod(s) * dtype.itemsize
        if ddp:
            out["buckets"] += 4 * _local_numel(shape, c)
    out["params"] += sum(b.numel() * b.element_size()
                         for b in model.buffers())
    out["replicated"] = sorted(replicated)
    return out


def batch_bytes(cfg, model, local_batch):
    """Bytes of the `local_batch` samples a step moves to the card: the
    entries the model reads (`batch_keys`, the images by default) of the
    config's synthetic stand-in, at its resolution and clip length."""
    from ..data.synthetic import synthetic_image_splits, \
        synthetic_video_splits
    if getattr(cfg, "n_sample_frames", None):
        train, _ = synthetic_video_splits(cfg, 1, 0)
    else:
        train, _ = synthetic_image_splits(cfg.copy(train_samples=1,
                                                   val_samples=0))
    sample = train[0]
    keys = getattr(model, "batch_keys", ("img",))
    return local_batch * sum(sample[k].nbytes for k in keys if k in sample)


def capacity(device=None):
    """The card's memory in bytes; H100_BYTES on a host without one."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return H100_BYTES


def size_plan(cfg, model, cards, tp=1, fsdp=False, global_batch=None,
              optimizer=None, activation_peak=None, hbm=None):
    """One row of the sizing table: `cfg`'s training step (global batch
    `global_batch`, the config's by default) on `cards` cards as data x
    tp (`fsdp`), its per-card state bytes from shard shapes, the batch,
    the measured `activation_peak` (None: not measured) and the
    verdict against `hbm` bytes a card (default: an H100's)."""
    if cards % tp:
        raise ValueError(f"{cards} cards do not split into TP {tp}")
    data = cards // tp
    global_batch = global_batch or cfg.train_batch_size
    if global_batch % data:
        raise ValueError(f"a batch of {global_batch} does not divide over "
                         f"{data} data ranks")
    local = global_batch // data
    from ..training.optim import core_name
    st = state_bytes(model, cfg, data, tp, fsdp, optimizer)
    row = {"n_cards": cards, "plan": plan_name(data, tp, fsdp),
           "data": data, "tp": tp, "fsdp": bool(fsdp),
           "optimizer": core_name(optimizer or getattr(
               cfg, "optimizer", "adam"), getattr(cfg, "weight_decay", 0.0)),
           "global_batch": global_batch, "local_batch": local,
           "params_per_card": st["params"], "opt_per_card": st["opt"],
           "ema_per_card": st["ema"], "buckets_per_card": st["buckets"],
           "batch_per_card": batch_bytes(cfg, model, local),
           "activation_peak_per_card": activation_peak,
           "hbm_per_card": hbm or H100_BYTES,
           "replicated": st["replicated"]}
    row["state_per_card"] = (st["params"] + st["opt"] + st["ema"] +
                             st["buckets"])
    if activation_peak is None:
        row["peak_per_card"] = row["fits"] = None
    else:
        row["peak_per_card"] = (row["state_per_card"] +
                                row["batch_per_card"] + activation_peak)
        row["fits"] = row["peak_per_card"] < row["hbm_per_card"]
    return row


def step_peak(trainer, batch):
    """The activation peak of one training step of `trainer` on `batch`
    on its card: `torch.cuda.max_memory_allocated` over the step less
    what is allocated as it starts (the state, and the batch, moved
    there first). A step is taken before, so the optimizer's state
    exists. None on the CPU."""
    if trainer.device.type != "cuda":
        return None
    batch = {k: v.to(trainer.device) if torch.is_tensor(v) else v
             for k, v in batch.items()}
    trainer.train_step(batch)
    torch.cuda.synchronize(trainer.device)
    torch.cuda.reset_peak_memory_stats(trainer.device)
    base = torch.cuda.memory_allocated(trainer.device)
    trainer.train_step(batch)
    torch.cuda.synchronize(trainer.device)
    return torch.cuda.max_memory_allocated(trainer.device) - base


def format_table(rows):
    """A markdown table of `size_plan` rows (the JAX `format_table`'s
    columns, "XLA temp" replaced by the measured activation peak, and
    DDP's buckets and the leaves kept replicated beside them)."""
    def mb(x):
        return "not measured" if x is None else f"{x / 2 ** 20:,.1f}"

    hdr = ("| cards | plan | global bs | local bs | params/card MB | "
           "opt/card MB | ema/card MB | DDP buckets/card MB | "
           "batch/card MB | activation peak/card MB | peak/card MB | HBM "
           "| fits | replicated where JAX shards |")
    lines = [hdr, "|" + "---|" * 14]
    for r in rows:
        fits = "-" if r["fits"] is None else ("yes" if r["fits"] else "NO")
        lines.append(
            f"| {r['n_cards']} | {r['plan']} | {r['global_batch']} | "
            f"{r['local_batch']} | {mb(r['params_per_card'])} | "
            f"{mb(r['opt_per_card'])} | {mb(r['ema_per_card'])} | "
            f"{mb(r['buckets_per_card'])} | {mb(r['batch_per_card'])} | "
            f"{mb(r['activation_peak_per_card'])} | "
            f"{mb(r['peak_per_card'])} | "
            f"{r['hbm_per_card'] / 2 ** 30:.0f} GiB | {fits} | "
            f"{len(r['replicated'])} |")
    return "\n".join(lines)
