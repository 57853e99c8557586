"""Extract every video's slots with the PyTorch port (the counterpart of
scripts/extract_slots.py): encode each whole video of each split in
chunks of the training clip length, the slots carried over, and write a
pickle of {split: {video name: slots [T, N, C] float32}}.

    python scripts/extract_slots_torch.py --params SAViLDMMoviFile64 \
        --weight checkpoint/torch_savi_ldm_movi_file-res64/model.pt \
        --data_root data_local/movi_file --save_path slots.pkl

A split the data root lacks is skipped (said on stdout). `--cpu` runs on
the CPU. The synthetic video-prediction chain extracts 8-frame videos of
the repo's trained model (`--seq_len 8`, as the JAX chain did):

    python scripts/extract_slots_torch.py --params SAViLDMSyntheticLong3_64 \
        --weight checkpoint/torch_savi_ldm_synthetic_long3-res64/model.pt \
        --save_path /tmp/slots.pkl --seq_len 8 --cpu --num_workers 0
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
    parser.add_argument("--save_path", required=True, help="the .pkl")
    parser.add_argument("--data_root", default="")
    parser.add_argument("--bs", type=int, default=4)
    parser.add_argument("--clip_len", type=int, default=-1,
                        help="chunk length (default: the training clip)")
    parser.add_argument("--seq_len", type=int, default=-1,
                        help="the clip length of datasets without whole "
                             "videos (the synthetic ones): sets "
                             "n_sample_frames, so also the chunk length")
    parser.add_argument("--num_workers", type=int, default=-1,
                        help="loader worker processes (default: the "
                             "config's)")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from slotdiffusion_tpu_torch.data import build_dataset
    from slotdiffusion_tpu_torch.data.loader import epoch_batches, make_loader
    from slotdiffusion_tpu_torch.methods.build import eval_setup, workers
    from slotdiffusion_tpu_torch.methods.inference import chunked_video_apply
    from slotdiffusion_tpu_torch.utils import dump_obj

    params, model, device = eval_setup(args.params, args.weight, args.cpu,
                                       args.data_root)
    if args.seq_len > 0:
        params.n_sample_frames = args.seq_len
    clip_len = args.clip_len if args.clip_len > 0 else params.n_sample_frames
    all_slots = {}
    for split in ("train", "val", "test"):
        try:
            ds = build_dataset(params, val_only=(split == "test"))
        except (FileNotFoundError, ValueError) as e:
            print(f"skip split {split}: {e}", flush=True)
            continue
        if isinstance(ds, tuple):
            ds = ds[0] if split == "train" else ds[1]
        if hasattr(ds, "load_video"):
            ds.load_video = True
        batches = epoch_batches(len(ds), args.bs, shuffle=False,
                                drop_last=False)
        loader = make_loader(ds, batches,
                             num_workers=workers(params, args))
        split_slots = {}
        with torch.inference_mode():
            for i, batch in enumerate(loader):
                slots = chunked_video_apply(
                    lambda x, prev: model({"img": x}, prev_slots=prev),
                    batch["img"].to(device), clip_len,
                    keys=("slots",))["slots"].cpu().numpy()
                for b, idx in enumerate(batch["data_idx"].tolist()):
                    name = os.path.basename(ds.files[idx]) \
                        if hasattr(ds, "files") else str(idx)
                    split_slots[name] = slots[b]
                if i % 10 == 0:
                    print(f"[{split} {i}/{len(batches)}]", flush=True)
        all_slots[split] = split_slots
        print(f"{split}: {len(split_slots)} videos", flush=True)
    dump_obj(all_slots, args.save_path)
    print(f"saved slots to {args.save_path}", flush=True)
    return all_slots


if __name__ == "__main__":
    main()
