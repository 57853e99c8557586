"""Train the PyTorch port's SAViDiffusion (the counterpart of
scripts/train.py for `slotdiffusion_tpu_torch`).

    python scripts/train_torch.py --vqvae_ckp_path vae.pt    # the card
    python scripts/train_torch.py --params SAViLDMMoviFile64 \
        --data_root data_local/movi_file                     # 64x64 MOVi
    python scripts/train_torch.py --cpu --tiny --max_steps 3 # CPU check
    python scripts/train_torch.py --bf16 ...                 # bf16 compute

`--params` names a port config: the flagship `SAViLDMMoviE128`
(SAViDiffusion, MOVi-E 128x128, 32 clips a step) or `SAViLDMMoviFile64`
(the repo's trained 64x64 model). The model starts from the JAX model's
own init (`init_reference_`, seeded; said on stdout) and trains against
the frozen stage-1 VQ-VAE that `--vqvae_ckp_path` names (a port-format
checkpoint). Without that path, `SAViLDMMoviFile64` takes the repo's
trained VQ-VAE as `scripts/export_torch_checkpoint.py --vqvae` exports
it, the flagship refuses to start, and `--tiny` (the flagship's structure
at narrow widths, 2 clips of 16x16 a step) keeps a random VQ-VAE.

With `--data_root` the clips come from a MOVi-layout tree
(`scripts/gen_movi_tree.py`), else from the synthetic clips at the
config's resolution. Validation (losses, FG-ARI, mIoU, mBO) runs every
`eval_interval` epochs and at the end. Checkpoints and the JSONL log go
to `--ckp_path` (default `checkpoint/torch_<run>/`, where the run is
`savi_ldm_movie` for the flagship, `tiny`, or the config's name):
`ckpt_last.pt` is rewritten atomically every `save_interval` of an epoch
and at the end; `--resume` continues from such a file.

`--bf16` (`use_bf16`, the JAX `scripts/train.py --bf16`) computes in bf16
with f32 master weights, gradients and Adam state; the checkpoints are
f32 and interchange with an f32 run's.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# default run directories that predate `--params`
RUN_NAMES = {"SAViLDMMoviE128": "savi_ldm_movie"}
# what `scripts/export_torch_checkpoint.py --vqvae` writes: the VQ-VAE of
# the repo's trained SAViLDMMoviFile64
EXPORTED_VQVAE = os.path.join(
    REPO, "checkpoint/torch_vqvae_synthetic_params-res64/vqvae.pt")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--max_steps", type=int, default=-1,
                        help="stop after this many steps (default: the "
                             "config's epochs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--params", default="SAViLDMMoviE128",
                        help="a port config: SAViLDMMoviE128 or "
                             "SAViLDMMoviFile64")
    parser.add_argument("--tiny", action="store_true",
                        help="the flagship's structure at narrow widths")
    parser.add_argument("--data_root", default="",
                        help="a MOVi-layout tree (default: synthetic clips)")
    parser.add_argument("--vqvae_ckp_path", default="",
                        help="port-format checkpoint of the frozen VQ-VAE")
    parser.add_argument("--ckp_path", default="")
    parser.add_argument("--resume", default="",
                        help="a ckpt_last.pt to continue from")
    parser.add_argument("--bf16", action="store_true",
                        help="compute in bf16 (f32 master weights)")
    args = parser.parse_args(argv)

    import torch

    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.data import build_datamodule
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_reference_

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to train on the CPU")
    device = "cpu" if args.cpu else "cuda"
    name = "tiny" if args.tiny else RUN_NAMES.get(args.params, args.params)
    cfg = configs.tiny_config() if args.tiny else \
        configs.get_config(args.params)
    cfg = cfg.copy(seed=args.seed, use_bf16=args.bf16 or cfg.use_bf16)
    vqvae = args.vqvae_ckp_path
    if not vqvae and args.params == "SAViLDMMoviFile64" and not args.tiny:
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
    elif not args.tiny:
        raise SystemExit("the LDM trains against a frozen stage-1 VQ-VAE: "
                         "pass --vqvae_ckp_path")
    else:
        print("the VQ-VAE is random (no --vqvae_ckp_path; the repo's "
              "trained one, for --params SAViLDMMoviFile64, comes from "
              "scripts/export_torch_checkpoint.py --vqvae)", flush=True)
    batch = cfg.train_batch_size
    model = build_model(cfg, device=device)
    init_reference_(model, torch.Generator().manual_seed(args.seed))
    print(f"initialized from the JAX model's reference init "
          f"(init_reference_, seed {args.seed})", flush=True)
    if args.data_root:
        data = build_datamodule(cfg.copy(data_root=args.data_root,
                                         dataset="movi"))
    else:
        data = SyntheticVideoData(cfg, batch, seed=args.seed,
                                  val_samples=2 * batch)
    ckp_path = args.ckp_path or os.path.join("checkpoint", f"torch_{name}")
    trainer = build_method(model, data, cfg, ckp_path=ckp_path)
    print(f"training {name} on {device} in "
          f"{'bf16' if cfg.use_bf16 else 'f32'}: {len(data)} steps per "
          f"epoch of {batch} clips, checkpoints in {ckp_path}", flush=True)
    trainer.fit(max_steps=args.max_steps if args.max_steps > 0 else None,
                resume_from=args.resume or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
