"""`chip_smoke.py`'s phase 17 (scale-out and cross-device export) alone on
the card, or with `--control` instead a run that must fail its gates: 2
gloo ranks on one card whose DDP never all-reduces a gradient (always in
`no_sync`), held against one process as phase 17 holds its runs (the
losses' largest relative difference, and `chip_smoke.state_distance` of
rank 0's ckpt_last).

    python3 scripts/scale_out_torch.py [--control]

Needs a CUDA card; builds the kernels from the checkout first.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def unsynced_rank(*args):
    """`chip_smoke.scale_rank` with DDP's gradient sync always off."""
    from slotdiffusion_tpu_torch.parallel import tp
    forward = tp.ShardingPlan.compute_losses

    def unsynced(self, *a, **kw):
        # DDP reads the switch in its forward (what `no_sync` sets)
        self.ddp.require_backward_grad_sync = False
        return forward(self, *a, **kw)

    tp.ShardingPlan.compute_losses = unsynced
    import chip_smoke
    chip_smoke.scale_rank(*args)


def control(dev):
    """-> (the losses' largest relative difference, the state distance)
    of the unsynchronised 2-rank run against one process."""
    import torch.multiprocessing as mp
    import chip_smoke
    from slotdiffusion_tpu_torch.training.checkpoint import load_checkpoint
    clips = chip_smoke.SCALE_CLIPS
    ref, report = chip_smoke.scale_fit(dev, {"clips": clips}, None,
                                       "control: one process")
    tmp = tempfile.mkdtemp()
    run = dict(name="unsynced", backend="gloo", world=2, tp=1, clips=clips,
               ckp=os.path.join(tmp, "ckp"), out=tmp)
    mp.start_processes(unsynced_rank, args=(2, chip_smoke.free_port(), run),
                       nprocs=2, start_method="spawn")
    with open(os.path.join(tmp, "rank0.json")) as f:
        losses = json.load(f)["losses"]
    want = [st["train/total_loss"] for st in report.steps]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    far = chip_smoke.state_distance(
        load_checkpoint(os.path.join(tmp, "ckp", "ckpt_last.pt")),
        ref.state_dict())
    return rel, far


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--control", action="store_true",
                        help="run the unsynchronised control instead")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke
    from slotdiffusion_tpu_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.time()
    _cuda.build()
    _cuda.lib()
    print(f"kernels built in {time.time() - t:.1f}s", flush=True)
    dev = torch.device("cuda")
    if not args.control:
        chip_smoke.scale_out(smi, dev)
    else:
        rel, far = control(dev)
        gates = rel > chip_smoke.SCALE_LOSS_RTOL, max(
            d for d, _ in far.values()) > chip_smoke.SCALE_STATE_TOL
        print(f"control (2 gloo ranks, never all-reduced): losses max rel "
              f"{rel:.3e}; state " + ", ".join(
                  f"{k} {d:.3e} ({n})" for k, (d, n) in far.items()) +
              f"; fails the loss gate {gates[0]}, the state gate "
              f"{gates[1]} [{smi}]", flush=True)
        if not all(gates):
            raise SystemExit("the control passed a gate")


if __name__ == "__main__":
    main()
