"""Train the PyTorch port's SAViDiffusion (the counterpart of
scripts/train.py for `slotdiffusion_tpu_torch`).

    python scripts/train_torch.py --vqvae_ckp_path vae.pt    # the card
    python scripts/train_torch.py --cpu --tiny --max_steps 3 # CPU check

The flagship config (SAViDiffusion, MOVi-E 128x128, 32 clips a step)
trains on synthetic 6-frame clips from random weights (seeded) against
the frozen stage-1 VQ-VAE that `--vqvae_ckp_path` names (a port-format
checkpoint; required); `--tiny` takes the flagship's structure at narrow
widths (2 clips of 16x16 a step) and, without that path, a random
VQ-VAE. Checkpoints and the JSONL log go to `--ckp_path` (default
`checkpoint/torch_<config>/`): `ckpt_last.pt` is rewritten atomically
every `save_interval` of an epoch and at the end; `--resume` continues
from such a file.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--max_steps", type=int, default=-1,
                        help="stop after this many steps (default: the "
                             "config's epochs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--tiny", action="store_true",
                        help="the flagship's structure at narrow widths")
    parser.add_argument("--vqvae_ckp_path", default="",
                        help="port-format checkpoint of the frozen VQ-VAE "
                             "(required unless --tiny)")
    parser.add_argument("--ckp_path", default="")
    parser.add_argument("--resume", default="",
                        help="a ckpt_last.pt to continue from")
    args = parser.parse_args(argv)

    import torch

    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_random_

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to train on the CPU")
    device = "cpu" if args.cpu else "cuda"
    name = "tiny" if args.tiny else "savi_ldm_movie"
    cfg = configs.tiny_config() if args.tiny else configs.SAViLDMMoviE128()
    cfg = cfg.copy(seed=args.seed)
    if args.vqvae_ckp_path:
        vae = dict(cfg.dec_dict["vae_dict"],
                   vqvae_ckp_path=args.vqvae_ckp_path)
        cfg = cfg.copy(dec_dict=dict(cfg.dec_dict, vae_dict=vae))
    elif not args.tiny:
        raise SystemExit("the LDM trains against a frozen stage-1 VQ-VAE: "
                         "pass --vqvae_ckp_path")
    else:
        print("the VQ-VAE is random (no --vqvae_ckp_path)", flush=True)
    batch = cfg.train_batch_size
    model = build_model(cfg, device=device)
    init_random_(model, torch.Generator().manual_seed(args.seed))
    data = SyntheticVideoData(cfg, batch, seed=args.seed)
    ckp_path = args.ckp_path or os.path.join("checkpoint", f"torch_{name}")
    trainer = build_method(model, data, cfg, ckp_path=ckp_path)
    print(f"training {name} on {device}: {len(data)} steps per epoch of "
          f"{batch} clips, checkpoints in {ckp_path}", flush=True)
    trainer.fit(max_steps=args.max_steps if args.max_steps > 0 else None,
                resume_from=args.resume or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
