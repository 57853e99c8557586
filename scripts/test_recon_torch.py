"""Reconstruction evaluation of the PyTorch port (the counterpart of
scripts/test_recon.py): encode each val clip or image to slots, decode
them (a diffusion model: DPM-Solver++, one noise sample shared over the
batch, `same_noise` as the JAX script passes it, then the VQ-VAE; SA and
SAVi: their spatial broadcast decoder; SLATE and STEVE: `recon_img`, every
token generated greedily by the AR decoder, then the dVAE), and report MSE
(summed per frame), PSNR and SSIM against the inputs; LPIPS too when
`SLOTDIFFUSION_LPIPS_WEIGHTS` names an `.npz`, under its provenance label
(`lpips(untrained-weights)` for a seeded stand-in).

    python scripts/test_recon_torch.py --params SAViLDMMoviFile64 \
        --weight checkpoint/torch_savi_ldm_movi_file-res64/model.pt \
        --data_root data_local/movi_file --bs 8
    python scripts/test_recon_torch.py --params SALDMSyntheticLong64 \
        --weight checkpoint/torch_sa_ldm_synthetic_long-res64/model.pt \
        --fid --save_video --cpu

Batch i samples from a generator seeded with i. Each batch's results go
into a cache (`<out_dir>/<config>.metrics.pkl`, by default under
`eval_cache/torch/`), rewritten after each batch; a rerun takes the
batches it finds there and computes only the rest. `--fid` / `--fvd`
(clips of >= 9 frames) add the Frechet distances of the reconstructions
against the inputs, natively, when `SLOTDIFFUSION_INCEPTION_WEIGHTS` /
`SLOTDIFFUSION_I3D_WEIGHTS` name converted `.npz` files (`ops/fid.py`,
`ops/fvd.py`); the raw features are cached, so a resumed run rebuilds the
exact statistics. `--save_video` writes each reconstructed frame as a PNG
under `<out_dir or eval_frames/torch>/<config>/`. `--cpu` runs on the
CPU.
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
    parser.add_argument("--out_dir", default="",
                        help="the cache's directory (and the frames' "
                             "parent); default eval_cache/torch")
    parser.add_argument("--save_video", action="store_true",
                        help="write the reconstructed frames as PNGs")
    parser.add_argument("--fid", action="store_true",
                        help="native FID against the inputs (needs "
                             "SLOTDIFFUSION_INCEPTION_WEIGHTS)")
    parser.add_argument("--fvd", action="store_true",
                        help="native FVD against the input clips (needs "
                             "SLOTDIFFUSION_I3D_WEIGHTS)")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)

    from slotdiffusion_tpu_torch.data import build_dataset
    from slotdiffusion_tpu_torch.data.loader import epoch_batches, make_loader
    from slotdiffusion_tpu_torch.methods.build import eval_setup, workers
    from slotdiffusion_tpu_torch.methods.evaluation import feature_fns, \
        recon_eval
    from slotdiffusion_tpu_torch.ops.lpips import WEIGHTS_ENV as LPIPS_ENV
    from slotdiffusion_tpu_torch.ops.lpips import lpips_available

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
    fid_fn, fvd_fn = feature_fns(args.fid, args.fvd)
    if not lpips_available():
        print(f"LPIPS is not computed: {LPIPS_ENV} names no file (the "
              "repository holds no LPIPS weights)", flush=True)
    name = os.path.basename(args.params)
    cache_path = os.path.join(args.out_dir or os.path.join(
        "eval_cache", "torch"), f"{name}.metrics.pkl")
    frames_dir = os.path.join(args.out_dir or os.path.join(
        "eval_frames", "torch"), name) if args.save_video else ""
    return recon_eval(model, params, loader, cache_path, device, fid_fn,
                      fvd_fn, frames_dir=frames_dir, total=len(batches))


if __name__ == "__main__":
    main()
