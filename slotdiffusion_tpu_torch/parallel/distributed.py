"""Multi-process start of the port (the counterpart of the JAX package's
parallel/distributed.py:31-77): one process per card, wired together by
`torch.distributed`.

`maybe_initialize_distributed()` decides whether this process is one of
a multi-process launch, and if so joins the process group before any
model or data is built (`scripts/train_torch.py` calls it first). The
launch is read from the environment, in the JAX package's order:

1. ``SLOTDIFFUSION_MULTIHOST=1``: an explicit opt-in; the rank, world
   size and local rank come from torchrun's variables or, failing them,
   Slurm's;
2. torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
   ``MASTER_ADDR`` / ``MASTER_PORT`` with ``WORLD_SIZE > 1``;
3. Slurm's ``SLURM_NTASKS > 1`` (``SLURM_PROCID``, ``SLURM_LOCALID``;
   the rendezvous at ``MASTER_ADDR`` or the launch node,
   ``MASTER_PORT`` or 29500).

A single-process run matches no rule and initialises nothing. On the
card a rank takes the card of its local rank (`torch.cuda.set_device`)
and the NCCL backend; gloo only when the caller asks for the CPU, as the
tests do. A failure to start NCCL raises: nothing falls back to gloo or
to the CPU.
"""

import os

import torch
import torch.distributed as dist

__all__ = ["detect_launch", "maybe_initialize_distributed"]

DEFAULT_PORT = 29500


def _env_int(env, name, default):
    try:
        return int(env.get(name, "") or default)
    except ValueError:
        return default


def detect_launch(env=None):
    """-> {"rank", "world_size", "local_rank", "init_method", "rule"} of
    the multi-process launch `env` (default `os.environ`) describes, or
    None for a single process."""
    env = os.environ if env is None else env

    def torchrun():
        return dict(rank=_env_int(env, "RANK", 0),
                    world_size=_env_int(env, "WORLD_SIZE", 1),
                    local_rank=_env_int(env, "LOCAL_RANK", 0),
                    init_method="env://")

    def slurm():
        addr = env.get("MASTER_ADDR") or env.get("SLURM_LAUNCH_NODE_IPADDR",
                                                 "localhost")
        port = _env_int(env, "MASTER_PORT", DEFAULT_PORT)
        return dict(rank=_env_int(env, "SLURM_PROCID", 0),
                    world_size=_env_int(env, "SLURM_NTASKS", 1),
                    local_rank=_env_int(env, "SLURM_LOCALID", 0),
                    init_method=f"tcp://{addr}:{port}")

    if env.get("SLOTDIFFUSION_MULTIHOST", "") not in ("", "0"):
        launch = torchrun() if "WORLD_SIZE" in env else slurm()
        return dict(launch, rule="SLOTDIFFUSION_MULTIHOST")
    if _env_int(env, "WORLD_SIZE", 1) > 1:
        return dict(torchrun(), rule="torchrun")
    if _env_int(env, "SLURM_NTASKS", 1) > 1:
        return dict(slurm(), rule="slurm")
    return None


def maybe_initialize_distributed(cpu=False, verbose=True, env=None):
    """Join the process group of the launch `detect_launch` finds; -> True
    iff a process group is (now) initialised (a one-rank group too, which
    the explicit opt-in can start). `cpu`: gloo on the CPU; else NCCL on
    the card of the local rank (RuntimeError without a card)."""
    if dist.is_available() and dist.is_initialized():
        return True
    launch = detect_launch(env)
    if launch is None:
        return False
    if cpu:
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("a multi-process launch on the card needs "
                               "CUDA; ask for the CPU to run over gloo")
        torch.cuda.set_device(launch["local_rank"])
        backend = "nccl"
    dist.init_process_group(backend, init_method=launch["init_method"],
                            rank=launch["rank"],
                            world_size=launch["world_size"])
    if verbose and launch["rank"] == 0:
        print(f"[distributed] {launch['world_size']} processes over "
              f"{backend} ({launch['rule']})", flush=True)
    return True

