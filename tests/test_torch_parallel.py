"""The port's scale-out path across processes (`slotdiffusion_tpu_torch.
parallel`, the data-parallel trainer), on the CPU over gloo.

The JAX package holds its multi-process fit against a single process
(tests/test_distributed.py); here the same holds for the port, in worker
processes (tests/torch_parallel_worker.py) started with torchrun's
variables, each with its own time limit (the multi-process cases read
one module fixture's runs: four launches, two at a time):

- the launch detection of `maybe_initialize_distributed`, on the
  environment alone;
- `DataModule`'s per-rank blocks against the JAX `DataLoader(
  process_index, process_count)`'s, and the draws of
  `global_batch_draws` against one process's;
- a 2-rank data-parallel `fit` of the tiny SAViDiffusion against the
  1-process fit, step for step (losses within 1e-5 relative), the ragged
  val batch left out with 2 ranks, and its checkpoints resumed across
  world sizes (2 -> 1 and 1 -> 2) to the uninterrupted run's state;
- one DP and one TP step at 2 ranks with injected timesteps and noise
  against the JAX model's loss and gradients, at the tolerance of
  tests/test_torch_train.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from slotdiffusion_tpu.data.loader import DataLoader as JaxDataLoader
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import convert_savi_diffusion
from slotdiffusion_tpu_torch.data.loader import DataModule
from slotdiffusion_tpu_torch.data.synthetic import synthetic_video_splits
from slotdiffusion_tpu_torch.models import build_model, init_random_
from slotdiffusion_tpu_torch.models.diffusion import noise_like
from slotdiffusion_tpu_torch.parallel import distributed, mesh as pmesh
from torch_parallel_worker import launch, task_lines
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, T_FRAMES,
                                  build_pair, t2n, tiny_baseline_config,
                                  video)

# ---- the launch, on the environment alone --------------------------------


@pytest.mark.parametrize("env,want", [
    pytest.param({}, None, id="single"),
    pytest.param({"WORLD_SIZE": "1", "RANK": "0"}, None, id="torchrun-1"),
    pytest.param({"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "1",
                  "MASTER_ADDR": "h", "MASTER_PORT": "1"},
                 dict(rank=2, world_size=4, local_rank=1,
                      init_method="env://", rule="torchrun"), id="torchrun"),
    pytest.param({"SLURM_NTASKS": "8", "SLURM_PROCID": "5",
                  "SLURM_LOCALID": "1", "MASTER_ADDR": "node0"},
                 dict(rank=5, world_size=8, local_rank=1,
                      init_method="tcp://node0:29500", rule="slurm"),
                 id="slurm"),
    pytest.param({"SLURM_NTASKS": "1"}, None, id="slurm-1"),
    pytest.param({"SLOTDIFFUSION_MULTIHOST": "1", "SLURM_NTASKS": "1",
                  "SLURM_PROCID": "0"},
                 dict(rank=0, world_size=1, local_rank=0,
                      init_method="tcp://localhost:29500",
                      rule="SLOTDIFFUSION_MULTIHOST"), id="opt-in"),
    pytest.param({"SLOTDIFFUSION_MULTIHOST": "1", "WORLD_SIZE": "2",
                  "RANK": "1", "SLURM_NTASKS": "9"},
                 dict(rank=1, world_size=2, local_rank=0,
                      init_method="env://", rule="SLOTDIFFUSION_MULTIHOST"),
                 id="opt-in-torchrun"),
])
def test_detect_launch_follows_the_jax_order(env, want):
    """The JAX package's order: the explicit opt-in, then torchrun's
    variables (its coordinator), then Slurm; one process matches none."""
    assert distributed.detect_launch(env) == want


def test_a_single_process_initialises_nothing():
    assert not distributed.maybe_initialize_distributed(cpu=True, env={})
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_a_card_launch_without_a_card_raises():
    """NCCL on the card, never a silent fall back to gloo or the CPU."""
    env = {"WORLD_SIZE": "2", "RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": "1"}
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.maybe_initialize_distributed(env=env)
    assert not dist.is_initialized()


# ---- the per-rank blocks and draws ---------------------------------------


class _Indexed:
    """Samples that are their own index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"data_idx": np.int32(i)}


@pytest.mark.parametrize("count", [2, 4])
def test_loader_blocks_equal_the_jax_loaders(count):
    """Each rank's block of every shuffled train batch, two epochs, equals
    the JAX `DataLoader(process_index, process_count)`'s; the blocks in
    rank order are the single-process batch."""
    n, batch, seed = 37, 8, 3
    data = _Indexed(n)
    for epoch in (0, 1):
        whole = [b["data_idx"].tolist() for b in DataModule(
            data, None, batch, seed=seed).train_loader(epoch)]
        got = []
        for rank in range(count):
            jl = JaxDataLoader(data, batch, shuffle=True, drop_last=True,
                               num_workers=1, seed=seed, process_index=rank,
                               process_count=count)
            jl.set_epoch(epoch)
            want = [b["data_idx"].tolist() for b in jl]
            mine = [b["data_idx"].tolist() for b in DataModule(
                data, None, batch, seed=seed, process_index=rank,
                process_count=count).train_loader(epoch)]
            assert mine == want and len(mine) == n // batch
            got.append(mine)
        assert [sum((g[i] for g in got), []) for i in range(len(whole))] \
            == whole


def test_ragged_val_batch_is_left_out_with_several_ranks():
    """10 val samples in batches of 4: the ragged last (2) divides over 2
    ranks; over 4 it is left out, as the JAX trainer skips it."""
    two = DataModule(_Indexed(8), _Indexed(10), 4, process_index=1,
                     process_count=2)
    assert [b["data_idx"].tolist() for b in two.val_loader()] == \
        [[2, 3], [6, 7], [9]]
    assert two.val_skipped == []
    four = DataModule(_Indexed(8), _Indexed(10), 4, process_index=3,
                      process_count=4)
    assert [b["data_idx"].tolist() for b in four.val_loader()] == [[3], [7]]
    assert four.val_skipped == [(2, 2)]
    with pytest.raises(ValueError, match="divide"):
        DataModule(_Indexed(8), None, 6, process_count=4)


def test_shard_batch_takes_contiguous_blocks():
    batch = {"img": torch.arange(12).reshape(6, 2), "n": 3,
             "idx": np.arange(6)}
    parts = [pmesh.shard_batch(batch, r, 3) for r in range(3)]
    assert torch.equal(torch.cat([p["img"] for p in parts]), batch["img"])
    assert parts[1]["idx"].tolist() == [2, 3] and parts[2]["n"] == 3


def test_global_batch_draws_keep_one_process_draws():
    """Every rank, drawing its block of a batch of 6 (frames of 3 clips
    each, as the model flattens them) inside `global_batch_draws`, takes
    the rows one process draws for the whole batch, and the generators
    end in the same state; a noise sample the batch shares (`same_noise`,
    a draw of leading dimension 1) is every rank's, and a 0-dim draw and
    another generator's are left alone."""
    def draws(gen, n):
        x = torch.empty(n, 2)
        return [torch.randn(n, 3, generator=gen),
                torch.randint(0, 50, (n * 3,), generator=gen),
                torch.rand((n, 4), generator=gen),
                x.exponential_(generator=gen).clone(),
                noise_like(gen, (n, 3), True, "cpu"),
                torch.randn((), generator=gen)]

    whole = draws(torch.Generator().manual_seed(0), 6)
    state = None
    for rank in range(3):
        gen = torch.Generator().manual_seed(0)
        other = torch.Generator().manual_seed(0)
        with pmesh.global_batch_draws(gen, rank, 3):
            part = draws(gen, 2)
            alone = torch.randn(4, generator=other)
        for w, p in zip(whole[:5], part[:5]):
            rows = w.shape[0] // 3
            assert torch.equal(p, w[rank * rows:(rank + 1) * rows])
        assert torch.equal(part[4][0], whole[4][0])
        assert torch.equal(part[5], whole[5])
        assert torch.equal(alone, torch.randn(
            4, generator=torch.Generator().manual_seed(0)))
        state = gen.get_state() if state is None else state
        assert torch.equal(gen.get_state(), state)


# ---- the data-parallel fit across processes ------------------------------


# a resumed run's state against the uninterrupted one's, 4 Adam updates
# later: the ranks sum each gradient in another order, and Adam divides
# every element's first moment by the root of its second, so an f32
# difference in a gradient near zero moves that element's update by a
# share of the LR; the largest measured is 2.2e-4 of a ResNet conv's scale
STATE_TOL = 1e-3


def _fit_spec(steps, ckp, **kw):
    cfg = configs.tiny_config().copy(
        train_batch_size=4, val_batch_size=4, max_epochs=3, print_iter=1,
        use_viz=False, save_interval=100.0, save_epoch_end=True,
        use_ema=True, async_ckpt=True)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    train, val = synthetic_video_splits(cfg, 8, 5, 0)
    return dict(task="fit", cfg=cfg, weights=model.state_dict(),
                train=train, val=val, steps=steps, ckp=str(ckp), **kw)


def _accumulated_spec(ckp, fsdp=False):
    spec = _fit_spec(2, ckp, fsdp=fsdp)
    spec["cfg"] = spec["cfg"].copy(grad_accum_steps=2, save_epoch_end=False)
    return spec


def _token_spec(ckp):
    cfg = tiny_baseline_config("STEVE", img_recon=True).copy(
        train_batch_size=4, max_epochs=1, print_iter=1, use_viz=False,
        save_interval=100.0, save_epoch_end=False, async_ckpt=False)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    train, _ = synthetic_video_splits(cfg, 8, 0, 0)
    return dict(task="fit", cfg=cfg, weights=model.state_dict(),
                train=train, val=None, steps=2, ckp=str(ckp))


def _side_by_side(tmp, *launches):
    """Each (tasks, world) as one `multi` launch of `world` processes, all
    at once -> [(rank 0's results by task, every rank's output)]."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(launches)) as pool:
        runs = [pool.submit(launch, dict(task="multi", tasks=tasks), world,
                            tmp, timeout=600)
                for tasks, world in launches]
        return [r.result() for r in runs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, pair):
    """The file's runs across processes from four launches, two at a
    time: one process and 2 ranks, then the resumes of each from the
    other's checkpoint. -> {task: (result, rank 0's output of it)}
    ("one/..." one process's, "two/..." the 2 ranks')."""
    tmp = tmp_path_factory.mktemp("parallel")
    one = {"fit": _fit_spec(4, tmp / "one"),
           "accumulated": _accumulated_spec(tmp / "one_accumulated"),
           "token": _token_spec(tmp / "one_token")}
    two = {"fit": _fit_spec(2, tmp / "two"),
           "accumulated_ddp": _accumulated_spec(tmp / "ddp"),
           "accumulated_fsdp": _accumulated_spec(tmp / "fsdp", fsdp=True),
           "token": _token_spec(tmp / "two_token"),
           **{f"grads_{name}": _grads_spec(pair, tp)
              for name, tp in (("dp2", 1), ("tp2", 2))}}
    first = _side_by_side(tmp, (one, 1), (two, 2))
    resumed = _side_by_side(
        tmp, ({"resumed": _fit_spec(4, tmp / "resumed1", resume=str(
            tmp / "two" / "ckpt_last.pt"))}, 1),
        ({"resumed": _fit_spec(4, tmp / "resumed2", resume=str(
            tmp / "one" / "ckpt_epoch1.pt"))}, 2))
    out = {}
    for who, (res, outs) in zip(("one", "two", "one", "two"),
                                first + resumed):
        for key, value in res.items():
            out[f"{who}/{key}"] = (value, task_lines(outs[0], key))
    return out


def _losses(records):
    return {r["step"]: r["train/total_loss"] for r in records
            if "train/total_loss" in r}


def _assert_state_close(a, b, what, tol=STATE_TOL):
    """Every parameter and EMA tensor (where there is an EMA) within
    `tol` of its scale."""
    assert (a["ema"] is None) == (b["ema"] is None), what
    pairs = [(k, a["model"][k], v) for k, v in b["model"].items()] + [
        (f"ema {k}", a["ema"]["shadow"][k], v)
        for k, v in (b["ema"] or {"shadow": {}})["shadow"].items()]
    worst = max(((x - y).abs().max().item() /
                 max(y.abs().max().item(), 1e-6), k) for k, x, y in pairs)
    assert worst[0] <= tol, f"{what}: {worst}"
    assert a["step"] == b["step"]


def test_dp_fit_matches_one_process_and_resumes_across_world_sizes(runs):
    """The 1-process fit of 4 steps (2 epochs of 2 global batches of 4
    clips, EMA on, saves on a thread) against: a 2-rank DDP fit of 2
    steps (the same losses; the ragged val batch left out), one process
    resuming from its ckpt_last to step 4, and 2 ranks resuming from the
    1-process run's ckpt_epoch1 to step 4: the losses of steps 3-4 and
    the final state of the uninterrupted run's."""
    one = runs["one/fit"][0]
    want = _losses(one["records"])
    assert sorted(want) == [1, 2, 3, 4] and one["plan"] is None

    two, printed = runs["two/fit"]
    assert two["plan"] == "ddp" and two["skipped"] == [(1, 1)]
    assert "skipped ragged batch 1 (1 samples)" in printed
    got = _losses(two["records"])
    assert sorted(got) == [1, 2]
    for s in got:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-5,
                                   err_msg=f"step {s}")

    for who, name in (("one", "2 -> 1"), ("two", "1 -> 2")):
        res = runs[f"{who}/resumed"][0]
        got = _losses(res["records"])
        assert sorted(got) == [3, 4], name
        for s in got:
            np.testing.assert_allclose(got[s], want[s], rtol=1e-5,
                                       err_msg=f"{name} step {s}")
        _assert_state_close(res["state"], one["state"], name)


@pytest.mark.parametrize("fsdp", [False, True], ids=["ddp", "fsdp"])
def test_accumulated_update_matches_one_process(runs, fsdp):
    """grad_accum_steps 2 (each micro-step's gradient averaged over the
    ranks in its own backward, the sums held aside): 2 ranks' losses, the
    `train/grad_norm` of every micro-step (the norm of its own global
    gradient, as one process logs it) and the state after one update
    equal one process's."""
    one = runs["one/accumulated"][0]
    two = runs[f"two/accumulated_{'fsdp' if fsdp else 'ddp'}"][0]
    assert two["plan"] == ("fsdp" if fsdp else "ddp")
    want, got = _losses(one["records"]), _losses(two["records"])
    assert sorted(got) == [1, 2]
    for s in got:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-5)
    norms = [{r["step"]: r["train/grad_norm"] for r in run["records"]
              if "train/grad_norm" in r} for run in (one, two)]
    assert sorted(norms[1]) == sorted(norms[0]) == [1, 2]
    for s in norms[0]:
        np.testing.assert_allclose(norms[1][s], norms[0][s], rtol=1e-5,
                                   err_msg=f"grad_norm step {s}")
    # one Adam update: lr g / (|g| + eps) moves an element whose small
    # gradient was summed in another order by a share of the LR (1.03e-5
    # of a ResBlock conv's scale measured)
    _assert_state_close(two["state"], one["state"], "accumulated",
                        tol=1e-4)


def test_token_model_dp_fit_matches_one_process(runs):
    """STEVE with its pixel loss, whose gumbel sample is drawn from the
    trainer's generator in every step: a 2-rank DDP fit of 2 steps of 4
    clips equals the 1-process fit (losses within 1e-5 relative, the
    state within STATE_TOL of each tensor's scale)."""
    one, two = runs["one/token"][0], runs["two/token"][0]
    assert two["plan"] == "ddp"
    want, got = _losses(one["records"]), _losses(two["records"])
    assert sorted(got) == sorted(want) == [1, 2]
    for s in got:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-5,
                                   err_msg=f"step {s}")
    _assert_state_close(two["state"], one["state"], "STEVE")


# ---- DP and TP steps against the JAX model --------------------------------

B = 2
LAT = (RES[0] // 4, RES[1] // 4, 3)


@pytest.fixture(scope="module")
def pair():
    return build_pair(use_pallas=False)


def _draws(seed=0):
    r = np.random.RandomState(seed)
    t = r.randint(0, 50, size=B * T_FRAMES)
    noise = r.randn(B * T_FRAMES, *LAT).astype(np.float32)
    return video(seed, B=B), t, noise


def _grads_spec(pair, tp):
    """2 ranks' loss and gradients at the JAX model's weights, clips,
    timesteps and noise (`grads`)."""
    cfg, _, _, tmodel = pair
    img, t, noise = _draws()
    spec = dict(task="grads", cfg=cfg.copy(train_batch_size=B),
                weights=copy.deepcopy(tmodel.state_dict()), train=None,
                tp=tp, inputs={"img": torch.from_numpy(img),
                               "t": torch.from_numpy(t),
                               "noise": torch.from_numpy(noise)})
    spec["train"], _ = synthetic_video_splits(spec["cfg"], B, 0, 0)
    return spec


@pytest.fixture(scope="module")
def jax_loss_and_grads(pair):
    """The tiny JAX model's denoising loss at the injected draws and its
    gradients (composed as tests/test_torch_train.py does)."""
    cfg, jmodel, jvars, _ = pair

    def f(m, img, t, noise):
        out = m({"img": img}, train=True)
        flat = img.reshape(-1, *img.shape[2:])
        slots = out["slots"].reshape(-1, SLOTS, SLOT_SIZE)
        dm = m.dm_decoder
        x0 = dm.encode_latent(flat)
        pred = dm.denoise(dm.q_sample(x0, t, noise), t, context=slots,
                          train=False)
        return jnp.mean((pred - noise) ** 2)

    img, t, noise = _draws()
    value, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(img),
                               jnp.asarray(t, jnp.int32),
                               jnp.asarray(noise), method=f)))(
        jvars["params"])
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("tp", [1, 2], ids=["dp2", "tp2"])
def test_two_rank_step_matches_jax(pair, jax_loss_and_grads, runs, tp):
    """2 ranks, data parallel (each rank 1 clip of 2) or tensor parallel
    (both the 2 clips, the UNet's attention and FFN sharded), with the
    JAX model's weights, clips, timesteps and noise: the loss to 1e-5
    relative and every gradient within tests/test_torch_train.py's
    tolerance (rtol 1e-4, atol 2e-5 of the leaf's or a hundredth of the
    model's largest gradient)."""
    cfg = pair[0]
    res = runs[f"two/grads_{'tp2' if tp == 2 else 'dp2'}"][0]
    want_loss, jgrads = jax_loss_and_grads
    np.testing.assert_allclose(res["loss"], want_loss, rtol=1e-5)
    want = convert_savi_diffusion(jgrads, cfg)
    grads = res["grads"]
    assert set(want) == set(grads)
    floor = 1e-2 * max(g.abs().max().item() for g in want.values())
    for name, w in want.items():
        g = grads[name]
        if name.startswith("dm_decoder.vae."):
            assert w.abs().max() == 0 and g.abs().max() == 0, name
            continue
        np.testing.assert_allclose(
            t2n(g), t2n(w), rtol=1e-4,
            atol=2e-5 * max(w.abs().max().item(), floor), err_msg=name)


# ---- the training script across processes --------------------------------


def test_apply_overrides_parses_literals():
    cfg = configs.tiny_config()
    configs.apply_overrides(cfg, ["lr=3e-4", "optimizer=adamw",
                                  "profile_steps=(1, 3)", "use_ema=True"])
    assert (cfg.lr, cfg.optimizer, cfg.profile_steps, cfg.use_ema) == \
        (3e-4, "adamw", (1, 3), True)
    with pytest.raises(ValueError, match="KEY=VALUE"):
        configs.apply_overrides(cfg, ["lr"])


@pytest.mark.parametrize("flags", [["--fsdp"], ["--set", "fsdp=True"],
                                   ["--tp", "2"]],
                         ids=["flag", "set", "tp"])
def test_train_script_refuses_a_plan_without_a_launch(flags, monkeypatch):
    """FSDP is the config's `fsdp`, set by `--fsdp` or `--set
    fsdp=True`; either, or `--tp 2`, in one process is refused before
    anything is built."""
    import importlib.util
    from torch_parallel_worker import LAUNCH_VARS, REPO
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    spec = importlib.util.spec_from_file_location(
        "train_torch", f"{REPO}/scripts/train_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with pytest.raises(SystemExit, match="multi-process launch"):
        script.main(["--cpu", "--tiny", *flags])


def test_train_script_under_torchrun_with_tp_and_fsdp(tmp_path):
    """`torchrun --nproc_per_node=2 scripts/train_torch.py --cpu --tiny
    --tp 2 --fsdp` (the tiny flagship, 2 clips a step, `--set` and
    `--max_epochs` applied) trains 2 steps and rank 0 writes one
    checkpoint in the single-process layout."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    from torch_parallel_worker import LAUNCH_VARS, REPO
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env["OMP_NUM_THREADS"] = "1"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ckp = tmp_path / "run"
    # its own session: a time-out ends torchrun and every rank it started
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         f"--master_port={port}", "scripts/train_torch.py", "--cpu",
         "--tiny", "--tp", "2", "--fsdp", "--max_steps", "2",
         "--max_epochs", "5", "--san_check_val_step", "0", "--set",
         "print_iter=1", "--set", "use_viz=False", "--ckp_path", str(ckp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=240)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    assert p.returncode == 0, out[-6000:]
    assert "2 processes: tp, mesh data 1 x model 2" in out
    state = torch.load(ckp / "ckpt_last.pt", weights_only=True)
    assert state["step"] == 2
    model = build_model(configs.tiny_config(), device="cpu")
    model.load_state_dict(state["model"], strict=True)
