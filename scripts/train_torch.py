"""Train the PyTorch port's SAViDiffusion, its image models (SADiffusion
and the SA baseline) or their stage-1 VQ-VAEs (the counterpart of
scripts/train.py for `slotdiffusion_tpu_torch`).

    # stage 1, then stage 2 on its checkpoint, on the card
    python scripts/train_torch.py --params VQVAEMoviE128 \
        --lpips_weights lpips.npz --data_root data/MOVi
    python scripts/train_torch.py --data_root data/MOVi \
        --vqvae_ckp_path checkpoint/torch_VQVAEMoviE128/ckpt_last.pt
    python scripts/train_torch.py --params SAViLDMMoviFile64 \
        --data_root data_local/movi_file                     # 64x64 MOVi
    python scripts/train_torch.py --cpu --tiny --max_steps 3 # CPU check
    python scripts/train_torch.py --cpu --params VQVAESynthetic64 \
        --max_steps 3                                        # stage 1, CPU
    python scripts/train_torch.py --bf16 ...                 # bf16 compute
    python scripts/train_torch.py --params SALDMCLEVRTex128 \
        --data_root data/CLEVRTex \
        --vqvae_ckp_path checkpoint/torch_VQVAECLEVRTex128/ckpt_last.pt
    python scripts/train_torch.py --cpu --params SASyntheticLong64 \
        --max_steps 3                                        # SA, CPU
    python scripts/train_torch.py --params DVAEMoviE128 \
        --data_root data/MOVi                                # dVAE
    python scripts/train_torch.py --params STEVEMoviE128 \
        --data_root data/MOVi \
        --dvae_ckp_path checkpoint/torch_DVAEMoviE128/ckpt_last.pt
    python scripts/train_torch.py --cpu --params STEVESyntheticLong64 \
        --max_steps 2                     # on the repo's exported dVAE

`--params` names a port config (`slotdiffusion_tpu_torch.configs`): the
flagship `SAViLDMMoviE128` (SAViDiffusion, MOVi-E 128x128, 32 clips a
step), its siblings, `SAViLDMMoviFile64` (the repo's trained 64x64
model), or a stage-1 VQ-VAE: `VQVAEMoviE128` (the flagship's, 64
frames a step) and its siblings, `VQVAESynthetic64` and
`VQVAESyntheticLPIPS64` (the repo's trained 64x64 ones); the image
family: `SALDMCLEVRTex128`, `SALDMCelebA128` (SADiffusion, 64 images a
step), their stage 1 `VQVAECLEVRTex128`, `VQVAECelebA128`, the SA
baseline `SACLEVRTex128`, `SACelebA128`, and the repo's trained 64x64
`SASyntheticLong64` and `SALDMSyntheticLong64`; the token and
reconstruction baselines: `SAViMoviE128` (SAVi) and its siblings,
`STEVEMoviE128` and its siblings with their stage 1 `DVAEMoviE128`...,
`SLATECLEVRTex128`, `SLATECelebA128` with `DVAECLEVRTex128`,
`DVAECelebA128`, and the repo's trained 64x64 `SAViSynthetic64`,
`DVAESyntheticLong64`, `SLATESyntheticLong64`, `STEVESyntheticLong64`.
SLATE and STEVE train against the frozen dVAE that `--dvae_ckp_path`
names (a dVAE run's `ckpt_last.pt`, or a SLATE or STEVE checkpoint);
`SLATESyntheticLong64` and `STEVESyntheticLong64` take the repo's trained
one as `scripts/export_torch_checkpoint.py --model dvae` exports it, the
others refuse to start without one. A dVAE's gumbel temperature anneals
by the step (`methods/build.py`). A VQ-VAE's
`ckpt_last.pt` is a file that a SAViDiffusion run takes as
`--vqvae_ckp_path` as it is. Its perceptual term is live when LPIPS
weights are given (`--lpips_weights`, or `SLOTDIFFUSION_LPIPS_WEIGHTS`;
said on stdout), as in the JAX package. The model starts from the JAX
model's
own init (`init_reference_`, seeded; said on stdout) and trains against
the frozen stage-1 VQ-VAE that `--vqvae_ckp_path` names (a port-format
checkpoint). Without that path, `SAViLDMMoviFile64` takes the repo's
trained VQ-VAE as `scripts/export_torch_checkpoint.py --vqvae` exports
it (so does `SALDMSyntheticLong64`, whose JAX run trained against the
same VQ-VAE), the other diffusion configs refuse to start, and `--tiny`
(the flagship's structure at narrow widths, 2 clips of 16x16 a step)
keeps a random VQ-VAE. SA has none.

With `--data_root` the clips come from a MOVi-layout tree
(`scripts/gen_movi_tree.py`; the STEVE-MOVi layout for the MOVi-Solid and
-Tex configs), and an image config's images from its CLEVRTex, CelebA,
COCO or VOC tree; else from synthetic clips or images at the config's
resolution (COCO-shaped ones for a COCO or VOC config; a config whose
dataset is `synthetic_video`, `synthetic` or `synthetic_coco` takes its
own split sizes). Validation (losses; FG-ARI, mIoU, mBO for
SAViDiffusion) runs every
`eval_interval` epochs and at the end. Checkpoints and the JSONL log go
to `--ckp_path` (default `checkpoint/torch_<run>/`, where the run is
`savi_ldm_movie` for the flagship, `tiny`, or the config's name):
`ckpt_last.pt` is rewritten atomically every `save_interval` of an epoch
and at the end (on a background thread unless the config's `async_ckpt`
is False), `ckpt_epoch{n}.pt` at each epoch's end where the config's
`save_epoch_end` says so; `--resume` continues from such a file. Before
the first step `--san_check_val_step` val batches are validated (2, as
the JAX script); `--max_steps` ends the run at that step with
`ckpt_last` and 4 val batches; `--profile_dir` writes a torch.profiler
trace of the config's `profile_steps`. The optimizer is the config's
`optimizer` (`weight_decay > 0`: adamw; `training/optim.py`).

The video-prediction stage (`SlotFormerSynthetic`,
`LDMSlotFormerSynthetic64` and its `Long2`/`Long3` runs,
`LDMSlotFormerPhysion128`, `ReadoutSynthetic`,
`ReadoutSyntheticRolloutLong`, `ReadoutPhysion`) trains on slots: the
config's synthetic trajectories, an extraction pickle
(`scripts/extract_slots_torch.py`) or a rollout pickle
(`scripts/rollout_physion_slots_torch.py`), which `--slots_root`
replaces; a Physion config reads the tree `--data_root` names. An
LDMSlotFormer grafts its frozen LDM from the raw `dm_decoder` of the
port-format SAViDiffusion file `--dm_ckp_path` names
(`LDMSlotFormerSynthetic64Long3`: by default the repo's trained one as
`scripts/export_torch_checkpoint.py --model savi_ldm_long3` exports it);
the slot MSE's loss decay anneals by the step.

    python scripts/train_torch.py --cpu --params SlotFormerSynthetic \
        --max_steps 3
    python scripts/train_torch.py --cpu --params \
        LDMSlotFormerSynthetic64Long3 --max_steps 3
    python scripts/train_torch.py --cpu --params \
        ReadoutSyntheticRolloutLong --slots_root /tmp/rollout.pkl

`--bf16` (`use_bf16`, the JAX `scripts/train.py --bf16`) computes in bf16
with f32 master weights, gradients and Adam state; the checkpoints are
f32 and interchange with an f32 run's. `--set KEY=VALUE` overrides any
config attribute (a Python literal, else a string) and `--max_epochs`
the config's epochs, as in the JAX script.

Across processes, one a card, under torchrun (or Slurm, or
`SLOTDIFFUSION_MULTIHOST=1`; `parallel/distributed.py`), NCCL on the
cards or gloo with `--cpu`:

    torchrun --nproc_per_node=4 scripts/train_torch.py ...   # DDP
    torchrun --nproc_per_node=4 scripts/train_torch.py --tp 2 --fsdp ...

The batch is the config's global one, split into one contiguous block a
data rank; `--tp N` shards the attention and FFN layers over N ranks
(`parallel/tp.py`), `--fsdp` (the config's `fsdp`, as `--set fsdp=True`)
shards parameters, optimizer state and the EMA over the data ranks
(FSDP2); without either it is DDP. Every rank
starts from the same seeded init; rank 0 logs and writes the one
checkpoint file, which resumes on any world size.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# default run directories that predate `--params`
RUN_NAMES = {"SAViLDMMoviE128": "savi_ldm_movie"}
# what `scripts/export_torch_checkpoint.py --vqvae` writes: the VQ-VAE of
# the repo's trained SAViLDMMoviFile64 and SALDMSyntheticLong64
EXPORTED_VQVAE = os.path.join(
    REPO, "checkpoint/torch_vqvae_synthetic_params-res64/vqvae.pt")
TAKES_EXPORTED_VQVAE = ("SAViLDMMoviFile64", "SALDMSyntheticLong64")
# what `scripts/export_torch_checkpoint.py --model dvae` writes: the dVAE
# the repo's trained SLATE and STEVE ran against
EXPORTED_DVAE = os.path.join(
    REPO, "checkpoint/torch_dvae_synthetic_long-res64/dvae.pt")
TAKES_EXPORTED_DVAE = ("SLATESyntheticLong64", "STEVESyntheticLong64")
IMAGE_DATASETS = ("synthetic", "synthetic_coco", "clevrtex", "celeba",
                  "coco", "voc")
# the video-prediction stage: its models read slots (and labels)
SLOT_STAGE = ("SlotFormer", "LDMSlotFormer", "PhysionReadout")
# what `scripts/export_torch_checkpoint.py --model savi_ldm_long3` writes
# (its raw dm_decoder): the frozen LDM of LDMSlotFormerSynthetic64Long3
EXPORTED_DM = {"LDMSlotFormerSynthetic64Long3": os.path.join(
    REPO, "checkpoint/torch_savi_ldm_synthetic_long3-res64/model.pt")}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--max_steps", type=int, default=-1,
                        help="stop after this many steps, then write "
                             "ckpt_last and validate 4 batches (the "
                             "config's max_steps; default: its epochs)")
    parser.add_argument("--san_check_val_step", type=int, default=2,
                        help="val batches to validate before the first "
                             "step (0: none)")
    parser.add_argument("--profile_dir", default="",
                        help="write a torch.profiler Chrome trace of the "
                             "config's profile_steps micro-steps here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--params", default="SAViLDMMoviE128",
                        help="a port config, e.g. SAViLDMMoviE128, "
                             "SAViLDMMoviFile64, VQVAEMoviE128, "
                             "VQVAESynthetic64")
    parser.add_argument("--tiny", action="store_true",
                        help="the flagship's structure at narrow widths")
    parser.add_argument("--data_root", default="",
                        help="a MOVi-layout tree (default: synthetic clips)")
    parser.add_argument("--vqvae_ckp_path", default="",
                        help="port-format checkpoint of the frozen VQ-VAE")
    parser.add_argument("--dvae_ckp_path", default="",
                        help="port-format checkpoint of SLATE's or STEVE's "
                             "frozen dVAE")
    parser.add_argument("--ckp_path", default="")
    parser.add_argument("--resume", default="",
                        help="a ckpt_last.pt to continue from")
    parser.add_argument("--bf16", action="store_true",
                        help="compute in bf16 (f32 master weights)")
    parser.add_argument("--lpips_weights", default="",
                        help="a VQ-VAE's LPIPS .npz (ops/lpips.py layout)")
    parser.add_argument("--dm_ckp_path", default="",
                        help="port-format SAViDiffusion checkpoint whose "
                             "raw dm_decoder an LDMSlotFormer grafts")
    parser.add_argument("--tp", type=int, default=1,
                        help="the model dim of the (data, model) mesh: "
                             "tensor-parallel attention and FFN layers")
    parser.add_argument("--fsdp", action="store_true",
                        help="set the config's fsdp: shard parameters, "
                             "optimizer state and the EMA over the data dim "
                             "(FSDP2); composes with --tp")
    parser.add_argument("--max_epochs", type=int, default=-1,
                        help="the config's max_epochs")
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="override a config attribute (a Python "
                             "literal, else a string); repeatable")
    parser.add_argument("--slots_root", default="",
                        help="the slots pickle of a slot-stage config "
                             "(its slots_root, or rollout_root for "
                             "synthetic_rollout_slots)")
    args = parser.parse_args(argv)

    import torch

    # a multi-process launch joins its group before anything is built
    from slotdiffusion_tpu_torch.parallel import (
        make_mesh, maybe_initialize_distributed)
    distributed = maybe_initialize_distributed(cpu=args.cpu)
    mesh = make_mesh(model=args.tp) if distributed else None

    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.data import build_datamodule
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_reference_
    from slotdiffusion_tpu_torch.ops.lpips import lpips_available
    from slotdiffusion_tpu_torch.parallel.mesh import data_coords

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to train on the CPU")
    device = torch.device("cpu") if args.cpu else \
        torch.device("cuda", torch.cuda.current_device())
    name = "tiny" if args.tiny else RUN_NAMES.get(args.params, args.params)
    cfg = configs.tiny_config() if args.tiny else \
        configs.get_config(args.params)
    cfg = cfg.copy(seed=args.seed, use_bf16=args.bf16 or cfg.use_bf16)
    if args.max_steps > 0:
        cfg = cfg.copy(max_steps=args.max_steps)
    if args.profile_dir:
        cfg = cfg.copy(profile_dir=args.profile_dir)
    if args.max_epochs > 0:
        cfg = cfg.copy(max_epochs=args.max_epochs)
    if args.fsdp:
        cfg = cfg.copy(fsdp=True)
    configs.apply_overrides(cfg, args.overrides)
    if (args.tp > 1 or cfg.fsdp) and not distributed:
        raise SystemExit("--tp and fsdp need a multi-process launch: "
                         "torchrun --nproc_per_node=N scripts/train_torch.py")
    stage1 = cfg.model == "VQVAE"
    ldm = cfg.model in ("SAViDiffusion", "SADiffusion")
    if stage1:
        if args.vqvae_ckp_path:
            raise SystemExit("a stage-1 VQ-VAE takes no --vqvae_ckp_path")
        cfg.lpips_weights = args.lpips_weights or cfg.lpips_weights
        if not cfg.vq_dict.get("percept_loss_w"):
            percept = "off (the config's percept_loss_w is 0)"
        elif lpips_available(cfg.lpips_weights):
            percept = "live"
        else:
            percept = ("off: no LPIPS weights (pass --lpips_weights or set "
                       "SLOTDIFFUSION_LPIPS_WEIGHTS)")
        print(f"the perceptual (LPIPS) term is {percept}", flush=True)
    vqvae = args.vqvae_ckp_path
    if vqvae and not ldm:
        raise SystemExit(f"{cfg.model} takes no --vqvae_ckp_path")
    if not vqvae and args.params in TAKES_EXPORTED_VQVAE and not args.tiny:
        if not os.path.isfile(EXPORTED_VQVAE):
            raise SystemExit(
                f"{EXPORTED_VQVAE} is missing: export the repo's trained "
                "VQ-VAE with scripts/export_torch_checkpoint.py --vqvae, "
                "or pass --vqvae_ckp_path")
        vqvae = EXPORTED_VQVAE
    if vqvae:
        print(f"the frozen VQ-VAE: {vqvae}", flush=True)
        vae = dict(cfg.dec_dict["vae_dict"], vqvae_ckp_path=vqvae)
        cfg = cfg.copy(dec_dict=dict(cfg.dec_dict, vae_dict=vae))
    elif not args.tiny and ldm:
        raise SystemExit("the LDM trains against a frozen stage-1 VQ-VAE: "
                         "pass --vqvae_ckp_path")
    elif ldm:
        print("the VQ-VAE is random (no --vqvae_ckp_path; the repo's "
              "trained one, for --params SAViLDMMoviFile64, comes from "
              "scripts/export_torch_checkpoint.py --vqvae)", flush=True)
    tokens = cfg.model in ("SLATE", "STEVE")
    dvae = args.dvae_ckp_path
    if dvae and not tokens:
        raise SystemExit(f"{cfg.model} takes no --dvae_ckp_path")
    if not dvae and args.params in TAKES_EXPORTED_DVAE:
        if not os.path.isfile(EXPORTED_DVAE):
            raise SystemExit(
                f"{EXPORTED_DVAE} is missing: export the repo's trained "
                "dVAE with scripts/export_torch_checkpoint.py --model dvae, "
                "or pass --dvae_ckp_path")
        dvae = EXPORTED_DVAE
    if dvae:
        print(f"the frozen dVAE: {dvae}", flush=True)
        cfg = cfg.copy(dvae_dict=dict(cfg.dvae_dict, dvae_ckp_path=dvae))
    elif tokens:
        raise SystemExit(f"{cfg.model} trains against a frozen stage-1 "
                         "dVAE: pass --dvae_ckp_path")
    dm = args.dm_ckp_path
    if dm and cfg.model != "LDMSlotFormer":
        raise SystemExit(f"{cfg.model} takes no --dm_ckp_path")
    if not dm and args.params in EXPORTED_DM:
        dm = EXPORTED_DM[args.params]
        if not os.path.isfile(dm):
            raise SystemExit(
                f"{dm} is missing: export the repo's trained SAViDiffusion "
                "with scripts/export_torch_checkpoint.py --model "
                "savi_ldm_long3, or pass --dm_ckp_path")
    if dm:
        print(f"the frozen LDM: the raw dm_decoder of {dm}", flush=True)
        cfg = cfg.copy(dec_dict=dict(cfg.dec_dict, dm_ckp_path=dm))
    elif cfg.model == "LDMSlotFormer":
        raise SystemExit("LDMSlotFormer's decoder is a trained LDM: pass "
                         "--dm_ckp_path")
    slot_stage = cfg.model in SLOT_STAGE
    if args.slots_root and not slot_stage:
        raise SystemExit(f"{cfg.model} takes no --slots_root")
    if args.slots_root:
        key = "rollout_root" if cfg.dataset == "synthetic_rollout_slots" \
            else "slots_root"
        cfg = cfg.copy(**{key: args.slots_root})
    batch = cfg.train_batch_size
    model = build_model(cfg, device=device)
    init_reference_(model, torch.Generator().manual_seed(args.seed))
    print(f"initialized from the JAX model's reference init "
          f"(init_reference_, seed {args.seed})", flush=True)
    images = cfg.dataset in IMAGE_DATASETS
    if slot_stage:
        if cfg.dataset.startswith("physion"):
            if not args.data_root:
                raise SystemExit(f"{cfg.dataset} reads a Physion tree: pass "
                                 "--data_root")
            cfg = cfg.copy(data_root=args.data_root)
        data = build_datamodule(cfg)
    elif args.data_root and images:
        data = build_datamodule(cfg.copy(data_root=args.data_root))
    elif args.data_root:
        # a MOVi tree, in the STEVE-MOVi layout for the configs that name it
        layout = "steve_movi" if cfg.dataset == "steve_movi" else "movi"
        data = build_datamodule(cfg.copy(data_root=args.data_root,
                                         dataset=layout))
    elif cfg.dataset in ("synthetic_video", "synthetic", "synthetic_coco"):
        data = build_datamodule(cfg)
    elif images:  # COCO and VOC fall back to COCO-shaped synthetic images
        fake = "synthetic_coco" if cfg.dataset in ("coco", "voc") \
            else "synthetic"
        data = build_datamodule(cfg.copy(dataset=fake, train_samples=256,
                                         val_samples=2 * batch))
    else:
        data = SyntheticVideoData(cfg, batch, seed=args.seed,
                                  val_samples=2 * batch)
    ckp_path = args.ckp_path or os.path.join("checkpoint", f"torch_{name}")
    if mesh is not None:
        # this data rank's block of every global batch
        data.set_process(*data_coords(mesh))
    trainer = build_method(model, data, cfg, ckp_path=ckp_path, mesh=mesh)
    if trainer.plan is not None and trainer.main:
        print(f"{torch.distributed.get_world_size()} processes: "
              f"{trainer.plan.kind}, mesh data {trainer.plan.data} x model "
              f"{trainer.plan.tp}", flush=True)
    print(f"training {name} ({cfg.model}) on {device} in "
          f"{'bf16' if cfg.use_bf16 else 'f32'}: {len(data)} steps per "
          f"epoch of {batch} {'images' if images else 'clips'}"
          f"{' of slots' if slot_stage else ''}, "
          f"checkpoints in {ckp_path}", flush=True)
    trainer.fit(resume_from=args.resume or None,
                san_check_val_step=args.san_check_val_step)
    if distributed:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
