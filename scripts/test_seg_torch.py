"""Segmentation evaluation of the PyTorch port (the counterpart of
scripts/test_seg.py): run a trained model over the val or test split,
take the argmax slot of every pixel, and report FG-ARI, ARI, mIoU,
FG-mIoU and mBO, T folded into H for a video; COCO and VOC each twice,
`inst/*` against the instance masks and `sem/*` against the semantic
ones, without COCO's overlap pixels.

    python scripts/test_seg_torch.py --params SACOCOFile64 \
        --weight checkpoint/torch_sa_coco_file-res64/model.pt \
        --data_root /tmp/seg/mini_coco --split val --cpu

    python scripts/test_seg_torch.py --params SAViLDMMoviFile64 \
        --weight checkpoint/torch_savi_ldm_movi_file-res64/model.pt \
        --data_root data_local/movi_file --split val --seq_len 2 -1
    python scripts/test_seg_torch.py --params SASyntheticLong64 \
        --weight checkpoint/torch_sa_synthetic_long-res64/model.pt \
        --split val                                 # images [B, N, H, W]

For a video model `--seq_len` sweeps clip lengths; -1 is the whole
video, which runs in chunks of the training clip length with the slots
carried over (`methods/inference.py:chunked_video_apply`). An image model
(SA: its decoder's masks; SADiffusion: slot attention's, upsampled;
SLATE: slot attention's at the visual resolution) takes each batch whole.
SAVi's masks are its decoder's; STEVE's are slot attention's at the
visual resolution, as the JAX script feeds them to `seg_metrics_fn` (no
upsampling: a model whose features are coarser than its input fails
there, as in the JAX script). `--cpu` runs on the CPU.

    python scripts/test_seg_torch.py --params STEVESyntheticLong64 \
        --weight checkpoint/torch_steve_synthetic_long-res64/model.pt \
        --split val --cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def evaluate(params, args, model, device, seq_len, clip_len):
    """One sweep value; -> {metric: mean}. `clip_len` is the training
    clip length, captured before the sweep changes `n_sample_frames`
    (None for an image model)."""
    import torch

    from slotdiffusion_tpu_torch.data import build_dataset, collate_fn
    from slotdiffusion_tpu_torch.data.loader import epoch_batches, make_loader
    from slotdiffusion_tpu_torch.methods.build import (seg_metrics_fn,
                                                       workers)
    from slotdiffusion_tpu_torch.methods.inference import chunked_video_apply
    from slotdiffusion_tpu_torch.utils import AverageMeter

    full_video = seq_len <= 0
    if clip_len is not None:
        params.n_sample_frames = clip_len if full_video else seq_len
    params.load_mask = True
    val_set = build_dataset(params, val_only=(args.split == "test"))
    if isinstance(val_set, tuple):
        val_set = val_set[1]
    if full_video and hasattr(val_set, "load_video"):
        val_set.load_video = True
    bs = args.bs if args.bs > 0 else params.val_batch_size
    batches = epoch_batches(len(val_set), bs, shuffle=False, drop_last=False)
    loader = make_loader(val_set, batches,
                         num_workers=workers(params, args),
                         collate_fn=collate_fn(params))
    meters = {}
    with torch.inference_mode():
        for i, batch in enumerate(loader):
            img = batch["img"].to(device)
            if clip_len is not None and img.shape[1] > clip_len:
                out = chunked_video_apply(
                    lambda x, prev: model({"img": x}, prev_slots=prev),
                    img, clip_len, keys=("slots", "masks"))
            else:
                out = model({"img": img})
            for k, v in seg_metrics_fn(batch, out).items():
                meters.setdefault(k, AverageMeter()).update(v, img.shape[0])
            if i % 10 == 0:
                print(f"[{i}/{len(batches)}] " + " ".join(
                    f"{k}={m.avg:.4f}" for k, m in meters.items()),
                    flush=True)
    label = "full" if full_video else str(seq_len)
    print(f"{args.params}, L={label}")
    for k, m in meters.items():
        print(f"{k}: {m.avg * 100.:.2f}")
    print("FINAL " + " ".join(f"{k}={m.avg:.4f}" for k, m in meters.items()),
          flush=True)
    return {k: m.avg for k, m in meters.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--params", required=True, help="a port config")
    parser.add_argument("--weight", required=True,
                        help="a port-format checkpoint (.pt)")
    parser.add_argument("--data_root", default="")
    parser.add_argument("--bs", type=int, default=-1)
    parser.add_argument("--split", default="test", choices=["val", "test"])
    parser.add_argument("--seq_len", nargs="+", type=int, default=[-1],
                        help="clip lengths to sweep; -1 = the whole video")
    parser.add_argument("--num_workers", type=int, default=-1,
                        help="loader worker processes (default: the "
                             "config's)")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)

    from slotdiffusion_tpu_torch.methods.build import eval_setup, workers
    from slotdiffusion_tpu_torch.models import is_video
    params, model, device = eval_setup(args.params, args.weight, args.cpu,
                                       args.data_root)
    if not is_video(params.model):  # an image model: no clips to sweep
        return [evaluate(params, args, model, device, -1, None)]
    clip_len = params.n_sample_frames
    return [evaluate(params, args, model, device, s, clip_len)
            for s in args.seq_len]


if __name__ == "__main__":
    main()
