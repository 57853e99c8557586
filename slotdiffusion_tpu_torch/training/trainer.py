"""The training loop of the port (mirrors the JAX package's
training/trainer.py:118-338, 548-606, one process, one card), for every
model the port builds.

One step: the model's `compute_losses` on a batch, the weighted total of
its `*_loss` entries (`{k}_w` weights from the config, 1.0 by default),
backward, then `training.optim.Optimizer` (global-norm clip, Adam with
per-group cosine-warmup LRs, k-step accumulation) and, when enabled, the
EMA tick after each update. Scalars the method schedules by the step
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

`validate` runs every `eval_interval` epochs and at the end of `fit`:
each val batch's `compute_losses` in eval mode with the live parameters
and, with an EMA, again with the EMA swapped in (`denoise_loss_ema`),
both from one generator seeded from (seed + 1, step, batch index); then
the host metrics (FG-ARI, mIoU, ...) of its outputs, where the method
gives a function for them (a VQVAE: losses only, as in the JAX
trainer). The means are weighted by batch size and logged with the
`val/` prefix.
"""

import json
import os
import time

import torch

from ..utils import AverageMeter
from .checkpoint import graft_pretrained, load_checkpoint, save_checkpoint
from .ema import ExponentialMovingAverage
from .optim import Optimizer


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


class Trainer:
    """Trains `model` (a built SAViDiffusion or VQVAE on its device) on
    `datamodule` (a `data.loader.DataModule`) with the settings of
    `params`, and validates it on the datamodule's val loader (if any)
    with `host_metrics_fn(batch, out) -> {name: float}`. `step` counts
    micro-batches, as the JAX TrainState's."""

    def __init__(self, model, datamodule, params, ckp_path=None,
                 lr_groups=None, seed=0, host_metrics_fn=None,
                 step_scalars=None):
        self.model = model
        self.data = datamodule
        self.ckp_path = ckp_path
        self.device = next(model.parameters()).device
        graft_pretrained(model, params)
        for module in model.frozen_modules:
            module.requires_grad_(False)
        self.steps_per_epoch = len(datamodule)
        self.max_epochs = params.max_epochs
        k = max(int(params.grad_accum_steps), 1)
        total = max(self.max_epochs * self.steps_per_epoch // k, 1)
        self.optimizer = Optimizer(
            model.named_parameters(), lr=params.lr, total_steps=total,
            warmup_steps=int(params.warmup_steps_pct * total),
            min_lr=params.min_lr, clip_grad=params.clip_grad,
            grad_accum_steps=k, lr_groups=lr_groups)
        # either switch turns the EMA on, as in the JAX trainer
        # (training/trainer.py:181-182): the model's (dec_dict["use_ema"])
        # or the run's (params.use_ema); it covers the model's
        # `ema_prefix` subtree (the JAX `ema_filter_prefix`)
        use_ema = model.use_ema or params.use_ema
        self.ema = ExponentialMovingAverage(
            model, params.ema_decay, model.ema_prefix) if use_ema else None
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
        self.logger = JSONLLogger(ckp_path)
        self.step = 0

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

    def train_step(self, batch):
        """One micro-step on `batch`; -> metrics of the step (floats)."""
        t0 = time.time()
        _, losses = self.model.compute_losses(self.inputs(batch),
                                              self.generator,
                                              **self.sched_kwargs())
        total = self.weighted_total(losses)
        micro_norm = self.optimizer.backward(total)
        updated, norm = self.optimizer.step()
        if updated and self.ema is not None:
            self.ema.update(self.model)
        self.step += 1
        metrics = {f"train/{k}": v.item() for k, v in losses.items()}
        metrics["train/total_loss"] = total.item()
        # the norm of this micro-step's own gradient, as the JAX trainer
        # logs it on every micro-step
        metrics["train/grad_norm"] = float(
            norm if micro_norm is None else micro_norm)
        if updated:
            metrics["lr"] = self.optimizer.adam.param_groups[0]["lr"]
        metrics["step_seconds"] = time.time() - t0
        return metrics

    def fit(self, max_steps=None, resume_from=None):
        """Train until `max_steps` micro-steps in all (default: the
        config's epochs), from `resume_from` when given, then write
        `ckpt_last`. -> the metrics of the last step taken."""
        if resume_from:
            self.load_checkpoint(resume_from)
        self.model.train()
        end = self.max_epochs * self.steps_per_epoch \
            if max_steps is None else max_steps
        metrics = None
        while self.step < end:
            epoch, start = divmod(self.step, self.steps_per_epoch)
            for batch in self.data.train_loader(epoch, start):
                metrics = self.train_step(batch)
                if self.step % self.print_iter == 0 or self.step == end:
                    self.logger.log(dict(metrics, epoch=epoch), self.step)
                if self.step >= end:
                    break
                if self.step % self.save_every == 0:
                    self.save_checkpoint()
            epochs, rest = divmod(self.step, self.steps_per_epoch)
            if self.step < end and rest == 0 and \
                    epochs % self.eval_interval == 0:
                self.validate()
                self.model.train()
        self.validate()
        self.save_checkpoint()
        return metrics

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
        out, losses = self.model.compute_losses(data, gen, train=False,
                                                **sched)
        losses = {k: v.item() for k, v in losses.items()}
        if self.ema is not None:
            gen.set_state(state)
            with self.ema.swapped(self.model):
                _, ema = self.model.compute_losses(data, gen, train=False,
                                                   **sched)
            losses.update({f"{k}_ema": v.item() for k, v in ema.items()})
        return out, losses

    def validate(self):
        """Losses and host metrics over the datamodule's val loader, in
        eval mode; the means weighted by batch size are logged as
        `val/<name>` and returned. {} without a val loader. The model is
        left in eval mode."""
        loader = getattr(self.data, "val_loader", lambda: None)()
        if loader is None:
            return {}
        self.model.eval()
        meters = {}
        for i, batch in enumerate(loader):
            out, losses = self.eval_step(batch, i)
            if self.host_metrics_fn is not None:
                losses.update(self.host_metrics_fn(batch, out))
            n = batch["img"].shape[0] if "img" in batch \
                else len(batch["data_idx"])
            for k, v in losses.items():
                meters.setdefault(k, AverageMeter()).update(v, n)
        results = {f"val/{k}": m.avg for k, m in meters.items()}
        if results:
            self.logger.log(results, self.step)
        return results

    def state_dict(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "ema": None if self.ema is None else self.ema.state_dict(),
                "generator": self.generator.get_state()}

    def save_checkpoint(self):
        """Write `<ckp_path>/ckpt_last.pt` (atomically); -> its path, or
        None without a checkpoint directory."""
        if not self.ckp_path:
            return None
        path = os.path.join(self.ckp_path, "ckpt_last.pt")
        save_checkpoint(path, self.state_dict())
        return path

    def load_checkpoint(self, path):
        state = load_checkpoint(path)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])
        self.generator.set_state(state["generator"])
        self.step = state["step"]
