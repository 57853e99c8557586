"""The training loop of the port (mirrors the JAX package's
training/trainer.py:118-338, 548-606), for every model the port builds,
in one process or across several (`mesh`, below).

One step: the model's `compute_losses` on a batch, the weighted total of
its `*_loss` entries (`{k}_w` weights from the config, 1.0 by default),
backward, then `training.optim.Optimizer` (global-norm clip, the core the
config's `optimizer` and `weight_decay` name, per-group cosine-warmup
LRs, k-step accumulation) and, when enabled, the EMA tick after each
update. Scalars the method schedules by the step
(`step_scalars`: the dVAE's gumbel temperature) reach `compute_losses`
as `sched`, in training and validation, as the JAX trainer's
`_sched_dict` does; so does SlotFormer's loss-decay factor. A batch
reaches `compute_losses` as the entries the model names in `batch_keys`
(the images by default; the slot models of the video-prediction stage
take slots, labels, `vid_len`). One seeded `torch.Generator` on the model's
device draws every diffusion timestep, noise, dropout mask and gumbel
sample of the run;
its state goes into each checkpoint with the model, the optimizer, the
EMA and the step, so a resumed run continues the same sequence (bit for
bit on the CPU). What the model declares frozen (`frozen_modules`:
SAViDiffusion's `dm_decoder.vae`, SLATE's and STEVE's `dvae`,
LDMSlotFormer's whole `dm_decoder`, nothing of a VQVAE) takes no gradient
and no update. Metrics go to stdout and `<ckp_path>/train_log.jsonl`.

Under `use_bf16` the model computes in bf16 while its parameters, and
so the gradients, the clipping norm (`train/grad_norm`) and Adam's
state, stay f32: the master weights of mixed precision.

The JAX trainer's settings, read from the config with its defaults
(training/trainer.py:148, 162, 370-386, 466-468, 483-541):

- `max_steps` (-1: off): at that many micro-steps `fit` writes
  `ckpt_last`, validates at most 4 val batches and returns;
- `fit(san_check_val_step=2)` validates that many val batches before the
  first step (`scripts/train.py`'s default);
- `save_epoch_end`: `ckpt_epoch{n}.pt` at the end of each epoch n;
- `profile_dir` / `profile_steps` ((10, 15)): a `torch.profiler` trace of
  micro-steps [a, b), CUDA activity too on the card, written as a Chrome
  trace `<profile_dir>/trace_steps{a}-{b}.json`;
- `use_wandb` / `wandb_id` / `wandb_name` / `project`: the records go to
  wandb too (`WandbLogger`), or, where `wandb` cannot be imported, to the
  JSONL log alone, said on stdout once;
- `async_ckpt` (True): a save copies the state to host memory at once and
  writes it on one background thread, one save in flight at a time;
  `wait_for_checkpoints()` runs before a load and at the end of `fit`;
  False: the save blocks. Both write the same file.

`validate` runs every `eval_interval` epochs and at the end of `fit`:
each val batch's `compute_losses` in eval mode with the live parameters
and, with an EMA, again with the EMA swapped in (`denoise_loss_ema`),
both from one generator seeded from (seed + 1, step, batch index); then
the host metrics (FG-ARI, mIoU, ...) of its outputs, where the method
gives a function for them (a VQVAE: losses only, as in the JAX
trainer). The means are weighted by batch size and logged with the
`val/` prefix. Then, with a checkpoint directory and the config's
`use_viz` (True by default), `viz_fn(trainer, first val batch, its
outputs, step, <ckp_path>/viz)` draws them (`methods/viz.py`); an error
there is printed and training goes on, as in the JAX trainer
(training/trainer.py:625-634).

Across processes (`mesh`, a ("data", "model") `DeviceMesh` of
`parallel.mesh.make_mesh`; the datamodule loads the rank's block of each
global batch): `parallel.tp.parallelize` lays the model out (DDP over
"data" when "model" is 1 and `fsdp` is off; else the TP plan over
"model", then FSDP2 over "data" with `fsdp`), and the optimizer and the
EMA follow its layout. Every rank keeps the same generator state and
draws for the global batch, keeping its rows (`parallel.mesh.
global_batch_draws`), so the losses equal a single process's on the same
global batch step for step; the logged losses are the means over "data".
A checkpoint is one file in the single-process layout, gathered from the
shards by every rank (in the loop, also under `async_ckpt`) and written
by rank 0, so a run resumes on another world size. Validation follows
the JAX trainer (training/trainer.py:556-612): a ragged last val batch is
left out with several data ranks; the host metrics are computed on the
rank's rows and averaged over "data"; printing, logging, the viz and
saves happen on rank 0 only. A sharded model (TP or FSDP) is drawn from
a whole copy that rank 0 builds from the gathered state (`viz_view`).
"""

import contextlib
import json
import os
import threading
import time
import types

import torch
import torch.distributed as dist

from ..parallel.mesh import data_coords, global_batch_draws, \
    prefetch_to_device
from ..parallel.tp import parallelize
from ..utils import AverageMeter
from .checkpoint import graft_pretrained, load_checkpoint, save_checkpoint
from .ema import ExponentialMovingAverage
from .optim import Optimizer, flax_layouts


class JSONLLogger:
    """Metrics to stdout and, with a directory, one JSON line per record."""

    def __init__(self, log_dir, name="train"):
        self.path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{name}_log.jsonl")

    def log(self, record, step):
        record = dict(record, step=int(step), time=time.time())
        print(f"[step {step}] " + " ".join(
            f"{k}={v:.5g}" for k, v in record.items()
            if k not in ("step", "time")), flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record


class SilentLogger:
    """The logger of a rank other than 0: records nothing."""

    def log(self, record, step):
        return dict(record, step=int(step), time=time.time())


class WandbLogger(JSONLLogger):
    """`JSONLLogger` plus wandb (the JAX package's WandbLogger,
    training/trainer.py:83-110): each record, without its time, goes to
    `wandb.log` at its step; a run id (`run_id`) resumes that run. Where
    `wandb` cannot be imported or its `init` fails, the records go to the
    JSONL log alone, and one line says so."""

    def __init__(self, log_dir, name="train", project=None, run_name=None,
                 run_id=None, config=None):
        super().__init__(log_dir, name)
        self.wandb = None
        try:
            import wandb
            wandb.init(project=project or "SlotDiffusionTPU", name=run_name,
                       id=run_id, resume="allow" if run_id else None,
                       config=config)
        except Exception as e:  # any failure: the JSONL log alone
            print(f"[wandb] not logging to wandb ({type(e).__name__}: {e});"
                  " the JSONL log alone", flush=True)
            return
        self.wandb = wandb

    def log(self, record, step):
        record = super().log(record, step)
        if self.wandb is not None:
            self.wandb.log({k: v for k, v in record.items() if k != "time"},
                           step=int(step))
        return record


def _config_dict(params):
    """The config's settings, plain values only (wandb's run config)."""
    out = {}
    for k in dir(params):
        v = getattr(params, k)
        if not k.startswith("_") and not callable(v):
            out[k] = v
    return out


def _to_host(tree):
    """A copy of every tensor of `tree` in host memory (nested dicts,
    lists and tuples kept), so training can go on changing the live
    ones."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class Trainer:
    """Trains `model` (a built SAViDiffusion or VQVAE on its device) on
    `datamodule` (a `data.loader.DataModule`) with the settings of
    `params`, and validates it on the datamodule's val loader (if any)
    with `host_metrics_fn(batch, out) -> {name: float}`. `step` counts
    micro-batches, as the JAX TrainState's."""

    def __init__(self, model, datamodule, params, ckp_path=None,
                 lr_groups=None, seed=0, host_metrics_fn=None,
                 step_scalars=None, viz_fn=None, mesh=None):
        self.model = model
        self.data = datamodule
        self.params = params
        self.ckp_path = ckp_path
        self.viz_fn = viz_fn  # the epoch-end visualisation
        self.device = next(model.parameters()).device
        graft_pretrained(model, params)
        for module in model.frozen_modules:
            module.requires_grad_(False)
        self.rank = dist.get_rank() if mesh is not None else 0
        self.main = self.rank == 0
        self.plan = None
        if mesh is not None:
            self.plan = parallelize(model, mesh,
                                    getattr(params, "fsdp", False))
        self.data_index, self.data_count = data_coords(mesh)
        if (datamodule.process_index, datamodule.process_count) != (
                self.data_index, self.data_count):
            raise ValueError(
                f"the datamodule loads block {datamodule.process_index} of "
                f"{datamodule.process_count}, the mesh's data rank is "
                f"{self.data_index} of {self.data_count}")
        self.steps_per_epoch = len(datamodule)
        self.max_epochs = params.max_epochs
        k = max(int(params.grad_accum_steps), 1)
        total = max(self.max_epochs * self.steps_per_epoch // k, 1)
        self.optimizer = Optimizer(
            model.named_parameters(), lr=params.lr, total_steps=total,
            warmup_steps=int(params.warmup_steps_pct * total),
            min_lr=params.min_lr, clip_grad=params.clip_grad,
            grad_accum_steps=k, lr_groups=lr_groups,
            optimizer=getattr(params, "optimizer", "adam"),
            weight_decay=getattr(params, "weight_decay", 0.0),
            layouts=flax_layouts(model), plan=self.plan)
        # either switch turns the EMA on, as in the JAX trainer
        # (training/trainer.py:181-182): the model's (dec_dict["use_ema"])
        # or the run's (params.use_ema); it covers the model's
        # `ema_prefix` subtree (the JAX `ema_filter_prefix`)
        use_ema = model.use_ema or params.use_ema
        self.ema = ExponentialMovingAverage(
            model, params.ema_decay, model.ema_prefix,
            self.plan) if use_ema else None
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self.host_metrics_fn = host_metrics_fn
        # {name: fn(step)}: scalars scheduled by the micro-step count (the
        # dVAE's gumbel temperature), passed to `compute_losses` as
        # `sched` (the JAX trainer's `_sched_dict`)
        self.step_scalars = dict(step_scalars or {})
        self.eval_interval = max(int(getattr(params, "eval_interval", 1)),
                                 1)
        self.loss_weights = {name: float(getattr(params, name))
                             for name in dir(params)
                             if name.endswith("_loss_w")}
        self.print_iter = params.print_iter
        self.save_every = max(int(params.save_interval *
                                  self.steps_per_epoch), 1)
        self.max_steps = int(getattr(params, "max_steps", -1))
        self.save_epoch_end = bool(getattr(params, "save_epoch_end", False))
        self.profile_dir = getattr(params, "profile_dir", "")
        self.profile_steps = tuple(getattr(params, "profile_steps",
                                           (10, 15)))
        self.async_ckpt = bool(getattr(params, "async_ckpt", True))
        if not self.main:
            self.logger = SilentLogger()
        elif getattr(params, "use_wandb", False):
            self.logger = WandbLogger(
                ckp_path, project=getattr(params, "project", None),
                run_name=getattr(params, "wandb_name", None),
                run_id=getattr(params, "wandb_id", None),
                config=_config_dict(params))
        else:
            self.logger = JSONLLogger(ckp_path)
        self.step = 0
        self._profiler = None
        self._saving = None  # (thread, [exception]) of the save in flight

    def sched_kwargs(self):
        """`{"sched": {name: value at this step}}` for `compute_losses`,
        or {} for a model without scheduled scalars."""
        if not self.step_scalars:
            return {}
        return {"sched": {k: fn(self.step)
                          for k, fn in self.step_scalars.items()}}

    def weighted_total(self, losses):
        return sum(self.loss_weights.get(f"{k}_w", 1.0) * v
                   for k, v in losses.items() if k.endswith("_loss"))

    def inputs(self, batch):
        """What `compute_losses` takes of `batch`, on the model's device:
        the entries the model names in `batch_keys` that the batch has
        (by default the images alone)."""
        keys = getattr(self.model, "batch_keys", ("img",))
        return {k: batch[k].to(self.device, non_blocking=True)
                for k in keys if k in batch}

    def batches(self, epoch, start):
        """The train batches of `epoch` from micro-step `start`; across
        processes each is copied to the card a batch ahead
        (`prefetch_to_device`, as the JAX trainer's loop); one process
        moves each in `inputs`."""
        loader = self.data.train_loader(epoch, start)
        if self.plan is None:
            return loader
        return prefetch_to_device(loader, self.device)

    def draws(self, generator):
        """The block inside which `generator` draws for the global batch
        and keeps this rank's rows (nothing to do on one data rank)."""
        if self.data_count == 1:
            return contextlib.nullcontext()
        return global_batch_draws(generator, self.data_index,
                                  self.data_count)

    def mean_losses(self, losses, total=None):
        """{name: float} of a rank's losses, the means over "data"
        (`total` added as "total_loss")."""
        named = dict(losses)
        if total is not None:
            named["total_loss"] = total
        keys = sorted(named)
        values = torch.stack([named[k].detach().float().reshape(())
                              for k in keys])
        if self.plan is not None:
            values = self.plan.data_mean(values)
        return dict(zip(keys, values.tolist()))

    def train_step(self, batch):
        """One micro-step on `batch`; -> metrics of the step (floats)."""
        t0 = time.time()
        compute = self.model.compute_losses if self.plan is None \
            else self.plan.compute_losses
        with self.draws(self.generator):
            _, losses = compute(self.inputs(batch), self.generator,
                                **self.sched_kwargs())
        total = self.weighted_total(losses)
        micro_norm = self.optimizer.backward(total)
        updated, norm = self.optimizer.step()
        if updated and self.ema is not None:
            self.ema.update(self.model)
        self.step += 1
        means = self.mean_losses(losses, total)
        metrics = {f"train/{k}": means[k] for k in losses}
        metrics["train/total_loss"] = means["total_loss"]
        # the norm of this micro-step's own (global) gradient, as the JAX
        # trainer logs it on every micro-step (training/optim.py)
        if micro_norm is not None or norm is not None:
            metrics["train/grad_norm"] = float(
                norm if micro_norm is None else micro_norm)
        if updated:
            metrics["lr"] = self.optimizer.lr
        metrics["step_seconds"] = time.time() - t0
        return metrics

    def fit(self, max_steps=None, resume_from=None, san_check_val_step=2):
        """Train until `max_steps` micro-steps in all (default: the
        config's epochs), from `resume_from` when given, after validating
        `san_check_val_step` val batches; then validate and write
        `ckpt_last`. The config's `max_steps` ends the run sooner, as the
        JAX trainer's does: `ckpt_last`, then at most 4 val batches.
        -> the metrics of the last step taken."""
        if resume_from:
            self.load_checkpoint(resume_from)
        if san_check_val_step:
            self.validate(max_steps=san_check_val_step)
        self.model.train()
        end = self.max_epochs * self.steps_per_epoch \
            if max_steps is None else max_steps
        metrics = None
        try:
            while self.step < end:
                epoch, start = divmod(self.step, self.steps_per_epoch)
                for batch in self.batches(epoch, start):
                    self._start_trace()
                    metrics = self.train_step(batch)
                    self._stop_trace()
                    capped = 0 < self.max_steps <= self.step
                    if self.step % self.print_iter == 0 or \
                            self.step == end or capped:
                        self.logger.log(dict(metrics, epoch=epoch),
                                        self.step)
                    if capped:
                        if self.main:
                            print(f"[max_steps {self.max_steps} reached]",
                                  flush=True)
                        self.save_checkpoint()
                        self.validate(max_steps=4)
                        return metrics
                    if self.step >= end:
                        break
                    if self.step % self.save_every == 0:
                        self.save_checkpoint()
                epochs, rest = divmod(self.step, self.steps_per_epoch)
                if rest == 0 and self.save_epoch_end:
                    self.save_checkpoint(f"epoch{epochs}")
                if self.step < end and rest == 0 and \
                        epochs % self.eval_interval == 0:
                    self.validate()
                    self.model.train()
            self.validate()
            self.save_checkpoint()
            return metrics
        finally:
            self._stop_trace(end=True)
            self.wait_for_checkpoints()

    def _start_trace(self):
        """Before micro-step `profile_steps[0]`: start the trace."""
        if self.profile_dir and self._profiler is None and \
                self.step == self.profile_steps[0]:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()

    def _stop_trace(self, end=False):
        """After micro-step `profile_steps[1] - 1` (or at the end of `fit`,
        `end`): stop the trace and write it."""
        a, b = self.profile_steps
        if self._profiler is None or not (end or self.step == b):
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_steps{a}-{b}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        print(f"[profile] micro-steps [{a}, {b}) -> {path}", flush=True)

    def _eval_generator(self, batch_idx):
        """A generator for val batch `batch_idx` at this step, seeded from
        (seed + 1, step, batch_idx), as the JAX trainer folds its key
        (training/trainer.py:330-334)."""
        seed = ((self.seed + 1) << 40) + self.step * 131071 + batch_idx
        return torch.Generator(device=self.device).manual_seed(
            seed % (1 << 63))

    @torch.no_grad()
    def eval_step(self, batch, batch_idx):
        """`compute_losses` on one val batch with the live parameters and,
        with an EMA, with the EMA swapped in (`*_ema`), both from the
        same draws; the live parameters are restored exactly. Call it in
        eval mode. -> (outputs of the live pass, {loss: float})."""
        data = self.inputs(batch)
        gen = self._eval_generator(batch_idx)
        state = gen.get_state()
        sched = self.sched_kwargs()
        with self.draws(gen):
            out, losses = self.model.compute_losses(data, gen, train=False,
                                                    **sched)
        losses = self.mean_losses(losses)
        if self.ema is not None:
            gen.set_state(state)
            with self.ema.swapped(self.model), self.draws(gen):
                _, ema = self.model.compute_losses(data, gen, train=False,
                                                   **sched)
            losses.update({f"{k}_ema": v
                           for k, v in self.mean_losses(ema).items()})
        return out, losses

    def validate(self, max_steps=None):
        """Losses and host metrics over the datamodule's val loader (its
        first `max_steps` batches, when given), in eval mode; the means
        weighted by batch size are logged as `val/<name>` and returned. {}
        without a val loader. The model is left in eval mode."""
        loader = getattr(self.data, "val_loader", lambda: None)()
        if loader is None:
            return {}
        self.model.eval()
        meters, first = {}, None
        # every rank decides alike: a sharded model's viz gathers it
        viz = self.viz_fn is not None and bool(self.ckp_path) and getattr(
            self.params, "use_viz", True)
        if self.main:
            for i, size in self.data.val_skipped:
                if max_steps is None or i < max_steps:
                    print(f"[val] skipped ragged batch {i} ({size} "
                          f"samples) over {self.data_count} data ranks",
                          flush=True)
        for i, batch in enumerate(loader):
            if max_steps is not None and i >= max_steps:
                break
            out, losses = self.eval_step(batch, i)
            if i == 0 and viz and self.main:
                first = (batch, out)
            if self.host_metrics_fn is not None:
                losses.update(self.host_metrics(batch, out))
            n = batch["img"].shape[0] if "img" in batch \
                else len(batch["data_idx"])
            for k, v in losses.items():
                meters.setdefault(k, AverageMeter()).update(v, n)
        results = {f"val/{k}": m.avg for k, m in meters.items()}
        if results:
            self.logger.log(results, self.step)
        if viz:
            try:
                view = self.viz_view()
                if first is not None:
                    self.viz_fn(view, *first, self.step,
                                os.path.join(self.ckp_path, "viz"))
            except Exception as e:  # a drawing never stops training
                print(f"[viz] skipped: {type(e).__name__}: {e}", flush=True)
        return results

    def viz_view(self):
        """What the viz draws with: the trainer itself, or, where the
        model is sharded (TP, FSDP), a view of it whose model is a whole
        copy in the single-process layout, built by rank 0 on its device
        from the gathered state (a collective: every rank calls it; the
        other ranks get None). The copy draws what one process would:
        the sharded forward's collectives need every rank, a drawing only
        rank 0."""
        if self.plan is None or not self.plan.shards_model:
            return self
        state = {k: self.plan.to_full(k, v)
                 for k, v in self.model.state_dict().items()}
        if not self.main:
            return None
        from ..models import build_model
        whole = build_model(self.params, device=self.device)
        whole.load_state_dict(state)
        whole.eval()
        return types.SimpleNamespace(model=whole, params=self.params,
                                     device=self.device, logger=self.logger)

    def host_metrics(self, batch, out):
        """`host_metrics_fn` on this rank's rows, averaged over "data"
        (the JAX trainer's `process_allgather` mean)."""
        local = self.host_metrics_fn(batch, out)
        if self.data_count == 1 or not local:
            return local
        keys = sorted(local)
        values = torch.tensor([float(local[k]) for k in keys],
                              dtype=torch.float64, device=self.device)
        return dict(zip(keys, self.plan.data_mean(values).tolist()))

    def state_dict(self):
        """The run's state, whole and in the single-process layout (under
        a plan a collective: every rank calls it)."""
        model = self.model.state_dict()
        if self.plan is not None:
            model = {k: self.plan.to_full(k, v) for k, v in model.items()}
        return {"model": model,
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "ema": None if self.ema is None else self.ema.state_dict(),
                "generator": self.generator.get_state()}

    def save_checkpoint(self, tag="last"):
        """Write `<ckp_path>/ckpt_{tag}.pt` (atomically): with `async_ckpt`
        the state is copied to host memory now and written on a
        background thread (after the save in flight, if any, is done);
        else the save blocks. -> its path, or None without a checkpoint
        directory."""
        if not self.ckp_path:
            return None
        path = os.path.join(self.ckp_path, f"ckpt_{tag}.pt")
        self.wait_for_checkpoints()
        state = _to_host(self.state_dict())
        if not self.main:  # rank 0 writes the gathered state
            return path
        if not self.async_ckpt:
            save_checkpoint(path, state)
            return path
        error = []

        def write():
            try:
                save_checkpoint(path, state)
            except Exception as e:  # raised again by the waiter
                error.append(e)

        thread = threading.Thread(target=write, name="ckpt-writer")
        thread.start()
        self._saving = (thread, error)
        return path

    def wait_for_checkpoints(self):
        """Block until the save in flight (if any) is on disk; a failed
        save raises here."""
        if self._saving is None:
            return
        thread, error = self._saving
        thread.join()
        self._saving = None
        if error:
            raise error[0]

    def load_checkpoint(self, path):
        """Load a checkpoint written by any world size (under a plan every
        rank reads the file, once rank 0's save in flight is on disk)."""
        self.wait_for_checkpoints()
        if self.plan is not None:
            dist.barrier()
        state = load_checkpoint(path)
        if self.plan is None:
            self.model.load_state_dict(state["model"])
        else:
            live = self.model.state_dict(keep_vars=True)
            if set(live) != set(state["model"]):
                raise KeyError(f"{path} does not hold this model's entries")
            for k, v in live.items():
                self.plan.copy_full_(k, v, state["model"][k])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])
        self.generator.set_state(state["generator"])
        self.step = state["step"]
