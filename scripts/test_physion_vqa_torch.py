"""Physion VQA accuracy of trained readouts of the PyTorch port (the
counterpart of scripts/test_physion_vqa.py): every checkpoint that
`--weight` names (a file or a glob) is swept over the sigmoid thresholds
`THRESHOLDS` on the config's test set (`subset="test"`; a dataset whose
name fixes its subset keeps it); the best accuracy (the first checkpoint
and threshold to reach it), then the per-task accuracies at that
setting.

    python scripts/test_physion_vqa_torch.py \
        --params ReadoutSyntheticRolloutLong \
        --weight checkpoint/torch_readout_synthetic_rollout_long/model.pt \
        --cpu --num_workers 0

Without `--cpu` it runs on the card.
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

THRESHOLDS = [0.4, 0.45, 0.5, 0.55, 0.6, 0.65]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--params", required=True, help="a port config")
    parser.add_argument("--weight", required=True,
                        help="a port-format checkpoint, or a glob of them")
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--data_root", default="")
    parser.add_argument("--slots_root", default="",
                        help="the rolled-out slots (default: the config's)")
    parser.add_argument("--num_workers", type=int, default=-1,
                        help="loader worker processes (default: the "
                             "config's)")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from slotdiffusion_tpu_torch.data import build_dataset
    from slotdiffusion_tpu_torch.data.loader import epoch_batches, make_loader
    from slotdiffusion_tpu_torch.methods.build import eval_setup, workers
    from slotdiffusion_tpu_torch.training.checkpoint import load_model_weights

    ckpts = sorted(glob.glob(args.weight)) or [args.weight]
    params, model, device = eval_setup(args.params, ckpts[0], args.cpu,
                                       args.data_root)
    params.subset = "test"
    if args.slots_root:
        key = "rollout_root" if hasattr(params, "rollout_root") \
            else "slots_root"
        setattr(params, key, args.slots_root)
    ds = build_dataset(params, val_only=True)
    loader = make_loader(ds, epoch_batches(len(ds), args.bs, shuffle=False,
                                           drop_last=False),
                         num_workers=workers(params, args))

    def predict(ckpt):
        """(probabilities, labels, task indices) over the test set."""
        load_model_weights(model, ckpt)
        probs, labels, tasks = [], [], []
        with torch.inference_mode():
            for batch in loader:
                logits = model({"slots": batch["slots"].to(device)},
                               train=False)["logits"]
                probs.append(torch.sigmoid(logits.float()).cpu())
                labels.append(batch["label"])
                tasks.append(batch["task_idx"])
        return tuple(torch.cat(x) for x in (probs, labels, tasks))

    best = (-1.0, None, None)
    for ckpt in ckpts:
        probs, labels, _ = predict(ckpt)
        for th in THRESHOLDS:
            acc = ((probs > th) == (labels > 0.5)).float().mean().item()
            if acc > best[0]:
                best = (acc, ckpt, th)
        print(f"{ckpt}: best-so-far acc={best[0]:.4f} @th={best[2]}",
              flush=True)
    acc, ckpt, th = best
    print(f"BEST acc={acc:.4f} ckpt={ckpt} threshold={th}", flush=True)
    probs, labels, tasks = predict(ckpt)
    all_tasks = getattr(ds, "all_tasks", sorted(set(tasks.tolist())))
    per_task = {}
    for ti, name in enumerate(all_tasks):
        sel = tasks == ti
        if sel.any():
            per_task[name] = ((probs[sel] > th) == (labels[sel] > 0.5)
                              ).float().mean().item()
            print(f"  {name}: acc={per_task[name]:.4f} "
                  f"(n={int(sel.sum())})", flush=True)
    return {"acc": acc, "ckpt": ckpt, "threshold": th, "per_task": per_task}


if __name__ == "__main__":
    main()
