"""Roll out future slots with a trained SlotFormer or LDMSlotFormer of the
PyTorch port (the counterpart of scripts/rollout_physion_slots.py): each
video's first `--obs_frames` slots are observed (45, 1.5 s at 30 FPS, on
Physion), the rest predicted, interleaved over the config's
`frame_offset` (`methods.inference.interleaved_rollout`), and every split
is written as the JAX script writes it: a pickle of {split: {video name:
slots [T, N, C] float32}, "_meta": {max_objects, seed, params}}.

    python scripts/rollout_physion_slots_torch.py \
        --params LDMSlotFormerSynthetic64Long3 \
        --weight checkpoint/torch_ldmslotformer_synthetic_long3-res64/model.pt \
        --save_path /tmp/rollout.pkl --obs_frames 4 --cpu --num_workers 0

A split the data lacks is skipped (said on stdout). Without `--cpu` it
runs on the card.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OBS_FRAMES = 45  # the burn-in of the upstream rollout_physion_slots.py


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--params", required=True, help="a port config")
    parser.add_argument("--weight", required=True,
                        help="a port-format checkpoint (.pt)")
    parser.add_argument("--save_path", required=True, help="the .pkl")
    parser.add_argument("--bs", type=int, default=16)
    parser.add_argument("--obs_frames", type=int, default=OBS_FRAMES,
                        help="observed (burn-in) frames")
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
    from slotdiffusion_tpu_torch.methods.inference import interleaved_rollout
    from slotdiffusion_tpu_torch.utils import dump_obj

    params, model, device = eval_setup(args.params, args.weight, args.cpu,
                                       args.data_root)
    if args.slots_root:
        params.slots_root = args.slots_root
    history_len = params.rollout_dict["history_len"]
    frame_offset = int(getattr(params, "frame_offset", 1))
    all_out = {}
    for split in ("train", "val", "test"):
        try:
            ds = build_dataset(params, val_only=(split == "test"))
        except (FileNotFoundError, ValueError, KeyError) as e:
            print(f"skip split {split}: {e}", flush=True)
            continue
        if isinstance(ds, tuple):
            ds = ds[0] if split == "train" else ds[1]
        batches = epoch_batches(len(ds), args.bs, shuffle=False,
                                drop_last=False)
        loader = make_loader(ds, batches, num_workers=workers(params, args))
        split_out = {}
        with torch.inference_mode():
            for i, batch in enumerate(loader):
                full = interleaved_rollout(
                    batch["slots"].to(device), model.rollout,
                    args.obs_frames, history_len, frame_offset)
                full = full.float().cpu().numpy()
                for b, idx in enumerate(batch["data_idx"].tolist()):
                    name = os.path.basename(ds.files[idx]) \
                        if hasattr(ds, "files") else str(idx)
                    split_out[name] = full[b]
                if i % 10 == 0:
                    print(f"[{split} {i}/{len(batches)}]", flush=True)
        all_out[split] = split_out
        print(f"{split}: {len(split_out)} videos", flush=True)
    # the renderer's settings the synthetic rollout labels are re-derived
    # with (data/synthetic_slots.py checks them at load)
    all_out["_meta"] = dict(max_objects=int(getattr(params, "max_objects",
                                                    -1)),
                            seed=int(params.seed), params=args.params)
    dump_obj(all_out, args.save_path)
    print(f"saved rollout slots to {args.save_path}", flush=True)
    return all_out


if __name__ == "__main__":
    main()
