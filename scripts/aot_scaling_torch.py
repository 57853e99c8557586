"""Per-card memory of the flagship's training step on NVIDIA cards under
DP, DP x TP and DP + FSDP (`slotdiffusion_tpu_torch.parallel.aot`): the
port's counterpart of scripts/aot_scaling.py, for 4 and 8 cards.

    python scripts/aot_scaling_torch.py [--params SAViLDMMoviE128] \
        [--cards 4,8] [--out rows.jsonl] [--cpu]

The state bytes of each row (parameters, optimizer state, EMA, DDP's
gradient buckets, the batch) come from shard shapes of the model built
on the meta device, with no card and no process group. On a card the
activation peak of each row is measured at the row's local batch (the
config's global batch over the data ranks): DP in this process; TP in
`tp` gloo ranks on the one card (a data rank's model, at its local
batch); FSDP in as many gloo ranks on the card as the row has data
ranks, at most FSDP_RANKS, at the row's local batch. With `--cpu`, or
on a host without a card, the peaks are null and the capacity an H100's
80 GiB. Prints one JSON line a row (and writes them to `--out`), the
card's name and power limit, then the table. Asserts what scripts/aot_scaling.py asserts: FSDP cuts the
per-card state below 0.6 of DP's, and TP shards parameter leaves.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PLANS = (("dp", 1, False), ("tp2", 2, False), ("fsdp", 1, True))
# the most gloo ranks an FSDP row is measured with on the one card (8
# ranks' CUDA contexts and caches do not fit on one 80 GB card beside
# their steps): FSDP's activation peak gathers the whole model whatever
# the number of data ranks, and the local batch stays the row's
FSDP_RANKS = 4


def _trainer(cfg, dev, mesh=None):
    """The config's model (random weights, seed 0) on `dev` in a trainer
    over synthetic clips at the config's batch; -> (trainer, its first
    batch)."""
    import torch
    from slotdiffusion_tpu_torch.data.loader import DataModule
    from slotdiffusion_tpu_torch.data.synthetic import synthetic_video_splits
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.parallel import data_coords
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    train, _ = synthetic_video_splits(cfg, 2 * cfg.train_batch_size, 0)
    index, count = data_coords(mesh)
    data = DataModule(train, None, cfg.train_batch_size, seed=0,
                      process_index=index, process_count=count)
    trainer = build_method(model, data, cfg, mesh=mesh)
    return trainer, next(iter(data.train_loader(0)))


def _cfg(name, batch, fsdp=False):
    from slotdiffusion_tpu_torch import configs
    return configs.get_config(name).copy(
        train_batch_size=batch, use_viz=False, fsdp=fsdp)


def peak_rank(rank, world, port, spec):
    """One gloo rank on the one card (spawned): the plan's trainer, its
    activation peak over a step (`aot.step_peak`) -> JSON in
    spec["out"]."""
    import torch
    import torch.distributed as dist
    from slotdiffusion_tpu_torch.parallel import aot, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    mesh = make_mesh(model=spec["tp"], device="cuda")
    cfg = _cfg(spec["params"], spec["global_batch"], spec["fsdp"])
    trainer, batch = _trainer(cfg, torch.device("cuda", 0), mesh)
    peak = aot.step_peak(trainer, batch)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump({"peak": peak}, f)
    dist.barrier()
    dist.destroy_process_group()


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def measure_peak(params, plan, tp, fsdp, data, local):
    """The activation peak of a row on the card: DP here, TP and FSDP in
    gloo ranks on the one card; -> bytes (the largest over the ranks)."""
    import gc

    import torch
    import torch.multiprocessing as mp
    from slotdiffusion_tpu_torch.parallel import aot
    if plan == "dp":
        trainer, batch = _trainer(_cfg(params, local), torch.device("cuda"))
        peak = aot.step_peak(trainer, batch)
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
        return peak
    world = tp if tp > 1 else min(data, FSDP_RANKS)
    out = tempfile.mkdtemp()
    spec = dict(params=params, tp=tp, fsdp=fsdp, out=out,
                global_batch=local * (1 if tp > 1 else world))
    mp.start_processes(peak_rank, args=(world, free_port(), spec),
                       nprocs=world, start_method="spawn")
    peaks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            peaks.append(json.load(f)["peak"])
    return max(peaks)


def check_invariants(rows):
    """scripts/aot_scaling.py's: FSDP's state a card below 0.6 of DP's,
    TP's parameters a card below DP's."""
    by = {}
    for r in rows:
        by.setdefault(r["n_cards"], {})[r["plan"]] = r
    for cards, plans in by.items():
        dp = plans[f"dp{cards}"]
        fsdp = plans[f"dp{cards}+fsdp"]
        tp = plans[f"dp{cards // 2}xtp2"]
        assert fsdp["state_per_card"] < 0.6 * dp["state_per_card"], (
            f"{cards} cards: FSDP state a card {fsdp['state_per_card']} not "
            f"below 0.6 of DP's {dp['state_per_card']}")
        assert tp["params_per_card"] < dp["params_per_card"], (
            f"{cards} cards: TP shards no parameter leaf")
    print("invariants OK: FSDP cuts the state a card below 0.6x DP; TP "
          "shards parameters", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--params", default="SAViLDMMoviE128")
    ap.add_argument("--cards", default="4,8")
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="size without the card (activation peaks null)")
    args = ap.parse_args(argv)
    import torch
    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.models import build_model
    from slotdiffusion_tpu_torch.parallel import aot
    on_card = torch.cuda.is_available() and not args.cpu
    smi = "no card (an H100's 80 GiB assumed)"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from slotdiffusion_tpu_torch.ops import _cuda
        _cuda.build()
        _cuda.lib()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = configs.get_config(args.params)
    meta = build_model(cfg, device="meta")
    hbm = aot.capacity("cuda" if on_card else None)
    rows = []
    for cards in (int(c) for c in args.cards.split(",")):
        for plan, tp, fsdp in PLANS:
            data = cards // tp
            local = cfg.train_batch_size // data
            peak, t = None, time.time()
            if on_card:
                peak = measure_peak(args.params, plan, tp, fsdp, data, local)
            row = aot.size_plan(cfg, meta, cards, tp, fsdp,
                                activation_peak=peak, hbm=hbm)
            row["measured_s"] = round(time.time() - t, 1)
            row["card"] = smi
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    check_invariants(rows)
    print(smi, flush=True)
    print(aot.format_table(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
