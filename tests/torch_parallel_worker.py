"""One process of the port's multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_tp_fsdp.py,
tests/test_torch_scale_state.py, tests/test_torch_aot.py).

    python tests/torch_parallel_worker.py <spec.pkl>

The launcher starts one such process a rank with torchrun's variables
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), or none for a
single process; the process joins the gloo group through
`parallel.maybe_initialize_distributed(cpu=True)`. The spec (a pickled
dict) holds the config, the starting weights (a state dict), the mesh's
model size and FSDP switch, the task and the output path; rank 0 writes
the task's result there with `torch.save`. The task `multi` runs a list
of tasks, each on a mesh of its own, so that one launch serves a test
module. Imports the port only.
"""

import os
import pickle
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from slotdiffusion_tpu_torch.data.loader import DataModule  # noqa: E402
from slotdiffusion_tpu_torch.methods.build import build_method  # noqa
from slotdiffusion_tpu_torch.models import build_model  # noqa: E402
from slotdiffusion_tpu_torch.parallel import (  # noqa: E402
    data_coords, make_mesh, maybe_initialize_distributed, shard_batch)


class Records:
    """A logger keeping every record."""

    def __init__(self):
        self.records = []

    def log(self, record, step):
        self.records.append(dict(record, step=int(step)))
        return record


def _trainer(spec, mesh, ckp_path=None):
    cfg = spec["cfg"].copy(fsdp=spec.get("fsdp", False))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(spec["weights"])
    index, count = data_coords(mesh)
    data = DataModule(spec["train"], spec.get("val"), cfg.train_batch_size,
                      cfg.val_batch_size, seed=0, process_index=index,
                      process_count=count)
    trainer = build_method(model, data, cfg, ckp_path=ckp_path, mesh=mesh)
    return trainer


def fit(spec, mesh):
    """`fit` to `spec["steps"]` micro-steps (from `spec["resume"]`);
    -> the step records, the final state and the printed skip lines."""
    trainer = _trainer(spec, mesh, spec["ckp"])
    rec = Records()
    if trainer.main:
        trainer.logger = rec
    trainer.fit(max_steps=spec["steps"], resume_from=spec.get("resume"),
                san_check_val_step=0)
    state = trainer.state_dict()
    return {"records": rec.records, "state": state,
            "plan": None if trainer.plan is None else trainer.plan.kind,
            "skipped": trainer.data.val_skipped}


def step(spec, mesh):
    """`spec.get("updates", 1)` trainer steps on the first global batches
    under each optimizer of `spec["optimizers"]`, each from the starting
    weights -> {optimizer: the metrics (of each step, with several), the
    updated parameters and EMA and the optimizer's per-parameter state,
    whole}, and the plan."""
    out = {}
    for name in spec["optimizers"]:
        trainer = _trainer(dict(spec, cfg=spec["cfg"].copy(optimizer=name)),
                           mesh)
        batches = iter(trainer.data.train_loader(0))
        metrics = [trainer.train_step(next(batches))
                   for _ in range(spec.get("updates", 1))]
        state = trainer.state_dict()
        out[name] = {"metrics": metrics[0] if len(metrics) == 1
                     else metrics, "params": state["model"],
                     "ema": state["ema"] and state["ema"]["shadow"],
                     "moments": {(i, k): v for i, st in state[
                         "optimizer"]["core"]["state"].items()
                         for k, v in st.items()
                         if torch.is_tensor(v) and v.dim()}}
    plan = trainer.plan
    return dict(out, plan=None if plan is None else plan.kind,
                replicated={} if plan is None else plan.replicated,
                styles={} if plan is None else plan.styles,
                fsdp_dims={} if plan is None else plan.fsdp_dims)


def grads(spec, mesh):
    """The loss of the injected clips, timesteps and noise (this rank's
    block of each) through the plan, and every gradient, whole."""
    trainer = _trainer(spec, mesh)
    index, count = data_coords(mesh)
    inputs = shard_batch(spec["inputs"], index, count)
    model = trainer.model
    model.train()
    compute = model.compute_losses if trainer.plan is None \
        else trainer.plan.compute_losses
    _, losses = compute({"img": inputs["img"]}, t=inputs["t"],
                        noise=inputs["noise"])
    losses["denoise_loss"].backward()
    if trainer.plan is not None:
        trainer.plan.reduce_grads()
    loss = trainer.mean_losses(losses)["denoise_loss"]
    out = {}
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[n] = g if trainer.plan is None else trainer.plan.to_full(n, g)
    return {"loss": loss, "grads": out}


def generate(spec, mesh):
    """Greedy AR generation from the injected slots (every rank the
    same) -> ids and logits."""
    trainer = _trainer(spec, mesh)
    dec = trainer.model.trans_decoder
    with torch.no_grad():
        ids, logits = dec.generate(spec["slots"], spec["gen_steps"])
    return {"ids": ids, "logits": logits,
            "heads": [blk.self_attn.num_heads for blk in dec.tf_dec.blocks]}


def optim_grads(spec, mesh):
    """`spec["updates"]` optimizer updates under each optimizer of
    `spec["optimizers"]` from the starting weights, each update's
    gradients seeded whole tensors (every rank the same; under a plan
    each rank gets its shards) -> {optimizer: the pre-clip norm of each
    update, the parameters and the optimizer's per-parameter state,
    whole}."""
    out = {}
    for name in spec["optimizers"]:
        trainer = _trainer(dict(spec, cfg=spec["cfg"].copy(optimizer=name)),
                           mesh)
        opt, plan = trainer.optimizer, trainer.plan
        gen = torch.Generator().manual_seed(1)
        norms = []
        for _ in range(spec["updates"]):
            for n, p in zip(opt.names, opt.params):
                g = torch.randn(p.shape, generator=gen) * 1e-2
                p.grad = g if plan is None else plan.from_full(n, g, p)
            norms.append(float(opt.step()[1]))
        state = trainer.state_dict()
        out[name] = {"norms": norms, "params": state["model"],
                     "moments": {(i, k): v for i, st in state[
                         "optimizer"]["core"]["state"].items()
                         for k, v in st.items()
                         if torch.is_tensor(v) and v.dim()}}
    return out


def viz(spec, mesh):
    """`validate` over the first val batch with a checkpoint directory
    and the viz on -> {file name: its bytes} of what rank 0 drew."""
    trainer = _trainer(spec, mesh, spec["ckp"])
    trainer.validate(max_steps=1)
    if not trainer.main:
        return None
    folder = os.path.join(spec["ckp"], "viz")
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = f.read()
    return out


def live_state_bytes(trainer):
    """The bytes a rank's `trainer` holds of its training state, from its
    live tensors (local shards), wherever they are: {"params" (and
    buffers), "opt" (the optimizer's whole state, `parallel.aot.
    state_bytes`'s "opt" and "opt_host"), "ema"}."""
    from slotdiffusion_tpu_torch.parallel.tp import _local

    def nbytes(t):
        t = _local(t)
        return t.numel() * t.element_size()

    model = trainer.model
    return {"params": sum(nbytes(p) for p in model.parameters()) +
            sum(nbytes(b) for b in model.buffers()),
            "opt": sum(nbytes(v) for st in trainer.optimizer.core.state
                       .values() for v in st.values() if torch.is_tensor(v)),
            "ema": 0 if trainer.ema is None else
            sum(nbytes(s) for s in trainer.ema.shadow.values())}


def state_bytes(spec, mesh):
    """One trainer step under each optimizer of `spec["optimizers"]`
    -> {optimizer: {"live": each rank's live state bytes (its local
    tensors), "predicted": `parallel.aot.state_bytes` of the model built
    on the meta device for the same plan}}."""
    import torch.distributed as dist
    from slotdiffusion_tpu_torch.parallel import aot
    _, data = data_coords(mesh)
    tp = 1 if mesh is None else mesh["model"].size()
    out = {}
    for name in spec["optimizers"]:
        trainer = _trainer(dict(spec, cfg=spec["cfg"].copy(optimizer=name)),
                           mesh)
        trainer.train_step(next(iter(trainer.data.train_loader(0))))
        ranks = [live_state_bytes(trainer)]
        if mesh is not None:
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, live_state_bytes(trainer))
        meta = build_model(trainer.params, device="meta")
        out[name] = {"live": ranks, "predicted": aot.state_bytes(
            meta, trainer.params, data, tp, trainer.params.fsdp, name)}
    return out


def adafactor_shards(spec, mesh):
    """`Adafactor` over hand-made parameters ({case: (shape, layout,
    dim)}: factored and packed layouts), each sharded along its `dim`
    over the mesh's "model" dim (whole without a mesh), 3 updates of
    seeded gradients -> {case: (the parameter, {state key: tensor}),
    whole}."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from slotdiffusion_tpu_torch.parallel.tp import ShardingPlan
    from slotdiffusion_tpu_torch.training.optim import Adafactor
    gen = torch.Generator().manual_seed(0)
    params, grads, layouts = {}, {}, {}

    def lay(t, dim):
        return t if mesh is None else distribute_tensor(
            t, mesh["model"], [Shard(dim)])

    for key, (shape, layout, dim) in spec["cases"].items():
        params[key] = torch.nn.Parameter(lay(torch.randn(
            shape, generator=gen), dim))
        grads[key] = [lay(torch.randn(shape, generator=gen), dim)
                      for _ in range(3)]
        if layout is not None:
            layouts[params[key]] = layout
    core = Adafactor([{"params": list(params.values()), "lr": 1e-2}],
                     layouts=layouts)
    for i in range(3):
        for key, p in params.items():
            p.grad = grads[key][i]
        core.step()
    plan = None if mesh is None else ShardingPlan(torch.nn.Module(), mesh)
    out = {}
    for key, p in params.items():
        state = {k: v if plan is None else plan.state_full(
            key, p, v, core.state_dims(p, k))
            for k, v in core.state[p].items() if v.dim()}
        out[key] = (p.detach() if plan is None else p.full_tensor(), state)
    return out


def multi(spec, mesh):
    """Every task of `spec["tasks"]` ({key: its spec, with its own "tp"}),
    each on a mesh of its own -> {key: its result}; each task's output
    on stdout between the lines `task_lines` looks for."""
    import time
    out = {}
    for key, sub in spec["tasks"].items():
        t = time.time()
        print(f"[multi] {key} starts", flush=True)
        sub_mesh = None if mesh is None else \
            make_mesh(model=sub.get("tp", 1))
        out[key] = TASKS[sub["task"]](sub, sub_mesh)
        print(f"[multi] {key} ends {time.time() - t:.1f}s", flush=True)
    return out


def task_lines(output, key):
    """What task `key` of a `multi` run printed, from a rank's output."""
    return output.split(f"[multi] {key} starts\n", 1)[1].split(
        f"[multi] {key} ends", 1)[0]


TASKS = {"fit": fit, "step": step, "grads": grads, "generate": generate,
         "optim_grads": optim_grads, "viz": viz, "state_bytes": state_bytes,
         "adafactor_shards": adafactor_shards, "multi": multi}
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT", "SLURM_NTASKS", "SLOTDIFFUSION_MULTIHOST")


def launch(spec, world, tmp, timeout=300):
    """Run `spec` in `world` worker processes (1: no process group), each
    with its own time limit; -> (rank 0's result, every rank's output).
    A rank that fails or outlives the limit fails the caller, and no
    process is left running."""
    import socket
    import subprocess
    import uuid
    path = os.path.join(str(tmp), f"spec-{uuid.uuid4().hex}.pkl")
    spec = dict(spec, out=path + ".out")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
        env["OMP_NUM_THREADS"] = "1"
        if world > 1:
            env.update(RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {world}:\n{out[-6000:]}"
    return torch.load(spec["out"], weights_only=False), outs


def main(path):
    with open(path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    distributed = maybe_initialize_distributed(cpu=True, verbose=False)
    mesh = make_mesh(model=spec.get("tp", 1)) if distributed else None
    result = TASKS[spec["task"]](spec, mesh)
    rank = torch.distributed.get_rank() if distributed else 0
    if rank == 0:
        torch.save(result, spec["out"])
    if distributed:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
