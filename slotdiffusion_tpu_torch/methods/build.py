"""Trainer configuration per model (mirrors the JAX package's
methods/build.py:25-131 for SAViDiffusion, SADiffusion, SA, SAVi, SLATE,
STEVE, the VQVAE, the dVAE, SlotFormer, LDMSlotFormer and the Physion
readout): for the diffusion models the
`dm_decoder` LR group at `dec_lr`, for SLATE and STEVE the
`trans_decoder` group; for the slot models the segmentation metrics of
each validation batch (`seg_metrics_fn`; SA's and SAVi's from their
decoder's masks, SLATE's and STEVE's from slot attention's at the visual
resolution); for the stage-1 VQVAE and dVAE one LR group and no metrics
beyond their losses, the dVAE's gumbel temperature annealed by the step;
for SlotFormer and LDMSlotFormer the slot MSE's loss-decay factor
annealed by the step (`use_loss_decay`); for the readout its accuracies,
which its `compute_losses` gives at eval; the run's seed for all. Each
loss is weighted by the config's `<loss>_w` (the trainer's lookup: SA's
`img_recon_loss_w`). COCO and VOC batches, which carry
instance masks, are scored twice (the dual protocol of upstream
img_based/test_seg.py): `inst/*` against the instance masks and `sem/*`
against the semantic ones, both with COCO's overlap pixels taken out."""

import torch

from ..models.blocks import cosine_anneal
from ..ops import metrics as M
from ..training.trainer import Trainer


def _mask_metrics(gt, pred_id, overlap=None, prefix=""):
    p = f"{prefix}/" if prefix else ""
    return {f"{p}ari": M.ARI_metric(gt, pred_id, overlap),
            f"{p}fari": M.fARI_metric(gt, pred_id, overlap),
            f"{p}miou": M.miou_metric(gt, pred_id, overlap),
            f"{p}fmiou": M.fmiou_metric(gt, pred_id, overlap),
            f"{p}mbo": M.mbo_metric(gt, pred_id, overlap)}


def seg_metrics_fn(batch, out):
    """ARI, FG-ARI, mIoU, FG-mIoU and mBO of the predicted soft masks
    `out["masks"]` ([B, N, H, W] or video [B, T, N, H, W], optionally with
    a trailing 1) against the integer masks `batch["masks"]`; {} without
    either. The argmax over the slots runs on the masks' device; a video
    folds T into H, so a slot must keep its object over the clip. A batch
    with `inst_masks` (COCO, VOC's val) gets each metric twice, `inst/*`
    against them and `sem/*` against `masks`, with its `overlap_masks`
    (COCO) passed to both (the JAX package's methods/build.py:36-70)."""
    if "masks" not in batch or "masks" not in out:
        return {}
    pred = out["masks"]
    if pred.shape[-1] == 1:
        pred = pred[..., 0]
    pred_id = pred.argmax(dim=-3)
    gt = torch.as_tensor(batch["masks"]).to(pred_id.device).long()
    if gt.shape[-2:] != pred_id.shape[-2:]:
        # the JAX function folds both at one resolution and fails here too
        raise ValueError(f"masks at {tuple(pred_id.shape[-2:])} and ground "
                         f"truth at {tuple(gt.shape[-2:])}: no upsampling "
                         "is done (STEVE and SLATE give slot attention's "
                         "masks at the visual resolution)")
    if pred_id.dim() == 4:  # video [B, T, H, W] -> [B, T * H, W]
        B, T, H, W = pred_id.shape
        pred_id = pred_id.reshape(B, T * H, W)
        gt = gt.reshape(B, T * H, W)
    if "inst_masks" in batch:
        inst = torch.as_tensor(batch["inst_masks"]).to(pred_id.device)
        overlap = batch.get("overlap_masks")
        if overlap is not None:
            overlap = torch.as_tensor(overlap).to(pred_id.device)
        res = _mask_metrics(inst.long(), pred_id, overlap, "inst")
        res.update(_mask_metrics(gt, pred_id, overlap, "sem"))
        return res
    return _mask_metrics(gt, pred_id)


SLOT_MODELS = ("SAViDiffusion", "SADiffusion", "SA", "SAVi", "SLATE",
               "STEVE")
# the decoder each family trains at `dec_lr` when that differs from `lr`
DECODERS = {"SAViDiffusion": "dm_decoder", "SADiffusion": "dm_decoder",
            "SLATE": "trans_decoder", "STEVE": "trans_decoder"}


def build_method(model, datamodule, params, ckp_path=None):
    """-> a `Trainer` for `model` as `params` configures it."""
    name = params.model
    if name in ("VQVAE", "PhysionReadout"):
        # the readout's accuracies come from its `compute_losses` at eval
        return Trainer(model, datamodule, params, ckp_path=ckp_path,
                       seed=params.seed)
    if name in ("dVAE", "DVAE"):
        # the gumbel temperature: `init_tau` -> `final_tau` by a cosine
        # over `tau_decay_pct` of the run's micro-steps
        total = params.max_epochs * len(datamodule)
        start, final = params.init_tau, params.final_tau
        tau_steps = params.tau_decay_pct * total
        return Trainer(model, datamodule, params, ckp_path=ckp_path,
                       seed=params.seed, step_scalars={
                           "gumbel_tau": lambda step: cosine_anneal(
                               step, start, final, 0, tau_steps)})
    if name in ("SlotFormer", "LDMSlotFormer"):
        # the loss decay: the factor rises from `loss_decay_min` to 1 by a
        # cosine over `loss_decay_pct` of the run's micro-steps (the JAX
        # methods/build.py:107-115), where `use_loss_decay` asks for it
        scalars = {}
        if getattr(params, "use_loss_decay", False):
            total = params.max_epochs * len(datamodule)
            low = getattr(params, "loss_decay_min", 0.1)
            decay_steps = getattr(params, "loss_decay_pct", 0.2) * total
            scalars["loss_decay_factor"] = lambda step: cosine_anneal(
                step, low, 1.0, 0, decay_steps)
        return Trainer(model, datamodule, params, ckp_path=ckp_path,
                       seed=params.seed, step_scalars=scalars)
    if name not in SLOT_MODELS:
        raise ValueError(f"training {name!r} is not ported yet")
    dec_lr = getattr(params, "dec_lr", params.lr)  # SA, SAVi: no decoder
    lr_groups = {DECODERS[name]: dec_lr} \
        if name in DECODERS and dec_lr != params.lr else None
    return Trainer(model, datamodule, params, ckp_path=ckp_path,
                   lr_groups=lr_groups, seed=params.seed,
                   host_metrics_fn=seg_metrics_fn)


def eval_setup(config, weight, cpu=False, data_root=""):
    """The shared start of the evaluation scripts: the port config named
    `config` (its `data_root` replaced when given), the model built on the
    card (the CPU with `cpu`) with the port-format `weight` loaded
    strictly, in eval mode. -> (params, model, device)."""
    from .. import configs
    from ..models import build_model
    from ..training.checkpoint import load_model_weights
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    device = torch.device("cpu" if cpu else "cuda")
    params = configs.get_config(config)
    if data_root:
        params.data_root = data_root
    model = build_model(params, device=device)
    load_model_weights(model, weight)
    return params, model.eval(), device


def workers(params, args):
    """Loader worker processes: `--num_workers` when given, else the
    config's."""
    return args.num_workers if args.num_workers >= 0 else \
        getattr(params, "num_workers", 0)
