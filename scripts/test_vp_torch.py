"""Video-prediction metrics of a trained LDMSlotFormer of the PyTorch port
(the counterpart of scripts/test_vp.py): each validation clip's first
`history_len` slots are observed, `rollout_len` frames' slots rolled out,
decoded by the frozen LDM (DPM-Solver++, one noise sample shared by the
batch, drawn from a generator seeded by the batch's index), and held
against the clip's frames by MSE (summed over each frame), PSNR and SSIM,
averaged over the frames.

    python scripts/test_vp_torch.py --params LDMSlotFormerSynthetic64Long3 \
        --weight checkpoint/torch_ldmslotformer_synthetic_long3-res64/model.pt \
        --bs 4 --max_batches 1 --cpu --num_workers 0

Without `--cpu` it runs on the card.
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
    parser.add_argument("--bs", type=int, default=4)
    parser.add_argument("--max_batches", type=int, default=-1)
    parser.add_argument("--data_root", default="")
    parser.add_argument("--slots_root", default="",
                        help="the extracted slots (default: the config's)")
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
    params.load_img = True
    if args.slots_root:
        params.slots_root = args.slots_root
    ds = build_dataset(params, val_only=True)
    batches = epoch_batches(len(ds), args.bs, shuffle=False, drop_last=False)
    loader = make_loader(ds, batches, num_workers=workers(params, args))
    history_len = params.rollout_dict["history_len"]
    rollout_len = params.loss_dict["rollout_len"]
    meters = {}
    with torch.inference_mode():
        for i, batch in enumerate(loader):
            if 0 < args.max_batches <= i:
                break
            past = batch["slots"][:, :history_len].to(device)
            gen = torch.Generator(device=device).manual_seed(i)
            frames = model.rollout(past, rollout_len, decode=True,
                                   with_gt=False,
                                   generator=gen)["recon_combined"]
            gt = batch["img"][:, history_len:history_len + rollout_len]
            x = (frames.float().cpu() * 0.5 + 0.5).clamp(0, 1)
            y = (gt.float() * 0.5 + 0.5).clamp(0, 1)
            x, y = (t.reshape(-1, *t.shape[2:]) for t in (x, y))
            res = {"mse": M.mse_metric(x, y), "psnr": M.psnr_metric(x, y),
                   "ssim": M.ssim_metric(x, y)}
            for k, v in res.items():
                meters.setdefault(k, AverageMeter()).update(v, x.shape[0])
            print(f"[{i}/{len(batches)}] " + " ".join(
                f"{k}={m.avg:.4f}" for k, m in meters.items()), flush=True)
    final = {k: m.avg for k, m in meters.items()}
    print("FINAL " + " ".join(f"{k}={v:.4f}" for k, v in final.items()),
          flush=True)
    return final


if __name__ == "__main__":
    main()
