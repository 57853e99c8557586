"""Reconstruction evaluation of the PyTorch port (the counterpart of
scripts/test_recon.py): encode each val clip or image to slots, decode
them (a diffusion model: DPM-Solver++, one noise sample shared over the
batch, `same_noise` as the JAX script passes it, then the VQ-VAE; SA and
SAVi: their spatial broadcast decoder; SLATE and STEVE: `recon_img`, every
token generated greedily by the AR decoder, then the dVAE), and report MSE (summed per frame), PSNR and
SSIM against the inputs.

    python scripts/test_recon_torch.py --params SAViLDMMoviFile64 \
        --weight checkpoint/torch_savi_ldm_movi_file-res64/model.pt \
        --data_root data_local/movi_file --bs 8
    python scripts/test_recon_torch.py --params SALDMSyntheticLong64 \
        --weight checkpoint/torch_sa_ldm_synthetic_long-res64/model.pt

Batch i samples from a generator seeded with i. LPIPS, FID and FVD are
not computed: the weights of their networks are not in the repo. `--cpu`
runs on the CPU.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--params", required=True, help="a port config")
    parser.add_argument("--weight", required=True,
                        help="a port-format checkpoint (.pt)")
    parser.add_argument("--data_root", default="")
    parser.add_argument("--bs", type=int, default=-1)
    parser.add_argument("--split", default="val", choices=["val", "test"])
    parser.add_argument("--max_batches", type=int, default=-1)
    parser.add_argument("--num_workers", type=int, default=-1,
                        help="loader worker processes (default: the "
                             "config's)")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from slotdiffusion_tpu_torch.data import build_dataset
    from slotdiffusion_tpu_torch.data.loader import epoch_batches, make_loader
    from slotdiffusion_tpu_torch.methods.build import eval_setup, workers
    from slotdiffusion_tpu_torch.ops import metrics as M
    from slotdiffusion_tpu_torch.utils import AverageMeter

    params, model, device = eval_setup(args.params, args.weight, args.cpu,
                                       args.data_root)
    val_set = build_dataset(params, val_only=(args.split == "test"))
    if isinstance(val_set, tuple):
        val_set = val_set[1]
    bs = args.bs if args.bs > 0 else params.val_batch_size
    batches = epoch_batches(len(val_set), bs, shuffle=False, drop_last=False)
    if args.max_batches > 0:
        batches = batches[:args.max_batches]
    loader = make_loader(val_set, batches,
                         num_workers=workers(params, args))
    print("LPIPS, FID and FVD are not computed: the weights of their "
          "networks are not in the repo", flush=True)
    meters = {}
    with torch.inference_mode():
        for i, batch in enumerate(loader):
            img = batch["img"].to(device)
            gen = torch.Generator(device=device).manual_seed(i)
            if params.model in ("SADiffusion", "SAViDiffusion"):
                samples = model.log_images({"img": img}, gen, use_dpm=True,
                                           same_noise=True)["samples"]
            elif params.model in ("SLATE", "STEVE"):
                samples = model.recon_img(model({"img": img}, testing=True)
                                          ["slots"], gen)
            else:
                samples = model({"img": img})["recon_img"]
            x = (samples * 0.5 + 0.5).clamp(0, 1).reshape(-1, *img.shape[-3:])
            y = (img * 0.5 + 0.5).clamp(0, 1).reshape(-1, *img.shape[-3:])
            results = {"mse": M.mse_metric(x, y), "psnr": M.psnr_metric(x, y),
                       "ssim": M.ssim_metric(x, y)}
            for k, v in results.items():
                meters.setdefault(k, AverageMeter()).update(v, img.shape[0])
            print(f"[{i}/{len(batches)}] " + " ".join(
                f"{k}={m.avg:.4f}" for k, m in meters.items()), flush=True)
    final = {k: m.avg for k, m in meters.items()}
    print("FINAL " + " ".join(f"{k}={v:.4f}" for k, v in final.items()),
          flush=True)
    return final


if __name__ == "__main__":
    main()
