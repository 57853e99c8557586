"""Compositional generation with the PyTorch port (the counterpart of
scripts/test_comp_gen.py): encode each val batch to slots, move slot k of
sample b to sample (b + k) mod B (`methods.comp_gen.shuffle_slots`),
decode the composed scenes with the model's decoder (a diffusion model:
DPM-Solver++ and the VQ decode; SLATE and STEVE: the AR decoder's greedy
tokens and the dVAE; SA and SAVi: the spatial broadcast decoder), and
write each composed frame as `<out_dir>/{count:06d}.png`.

    python scripts/test_comp_gen_torch.py --params SALDMSyntheticLong64 \
        --weight checkpoint/torch_sa_ldm_synthetic_long-res64/model.pt \
        --bs 4 --max_batches 1 --out_dir /tmp/cg --cpu

Batch i samples from a generator seeded with i. `--fid` / `--fvd` (clips
of >= 9 frames) add the Frechet distance of the composed frames against
the real ones, natively, when `SLOTDIFFUSION_INCEPTION_WEIGHTS` /
`SLOTDIFFUSION_I3D_WEIGHTS` name converted `.npz` files (`ops/fid.py`,
`ops/fvd.py`), printed under their provenance labels. Without `--cpu` it
runs on the card.
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
    parser.add_argument("--out_dir", default="comp_gen_frames")
    parser.add_argument("--max_batches", type=int, default=-1)
    parser.add_argument("--fid", action="store_true",
                        help="native FID of the composed frames against "
                             "the real ones (needs "
                             "SLOTDIFFUSION_INCEPTION_WEIGHTS)")
    parser.add_argument("--fvd", action="store_true",
                        help="native FVD on clips (needs "
                             "SLOTDIFFUSION_I3D_WEIGHTS)")
    parser.add_argument("--num_workers", type=int, default=-1,
                        help="loader worker processes (default: the "
                             "config's)")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)

    from slotdiffusion_tpu_torch.data import build_dataset
    from slotdiffusion_tpu_torch.data.loader import epoch_batches, make_loader
    from slotdiffusion_tpu_torch.methods.build import eval_setup, workers
    from slotdiffusion_tpu_torch.methods.evaluation import comp_gen_eval, \
        feature_fns

    params, model, device = eval_setup(args.params, args.weight, args.cpu,
                                       args.data_root)
    val_set = build_dataset(params, val_only=True)
    if isinstance(val_set, tuple):
        val_set = val_set[1]
    bs = args.bs if args.bs > 0 else params.val_batch_size
    # whole batches only: a composed scene takes slots from the others
    batches = epoch_batches(len(val_set), bs, shuffle=False, drop_last=True)
    if args.max_batches > 0:
        batches = batches[:args.max_batches]
    loader = make_loader(val_set, batches,
                         num_workers=workers(params, args))
    fid_fn, fvd_fn = feature_fns(
        args.fid, args.fvd, missing="WARNING: --{flag} requested but {env} "
        "is unset/missing; skipping native {FLAG}")
    return comp_gen_eval(model, params, loader, args.out_dir, device,
                         fid_fn, fvd_fn, total=len(batches))


if __name__ == "__main__":
    main()
