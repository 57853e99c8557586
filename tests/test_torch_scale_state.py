"""The state of a sharded run against one process's, on the CPU over gloo
(`slotdiffusion_tpu_torch.training.optim`, `parallel.tp`, `parallel.aot`,
the trainer's viz), from one launch of 2 worker processes
(tests/torch_parallel_worker.py, task `multi`) whose results the cases
read:

- every optimizer the plans used to refuse (`adam_fused`, `adam_bf16`,
  `adafactor`) under TP 2 and FSDP 2, 3 updates of the tiny flagship:
  the losses, `train/grad_norm`, the parameters and the optimizer's
  whole state against one process;
- `Adafactor` alone on hand-made parameters sharded along a factored
  dimension, another dimension, or a packed layout's (whose update
  gathers the gradient): parameters and statistics against one process;
- `train/grad_norm` on every micro-step under TP 2 with
  `grad_accum_steps` 2 against one process's;
- an FSDP run checkpointed between the micro-steps of an update and
  resumed ends where the uninterrupted run ends;
- the viz of a TP 2 and an FSDP 2 model: the files one process draws;
- `parallel.aot.state_bytes` of the model built on the meta device
  against the bytes of each rank's live state (its local tensors), under
  each plan at 2 ranks under Adam and adafactor (every optimizer at 4
  ranks: tests/test_torch_aot.py).
"""

import numpy as np
import pytest
import torch

from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.data.synthetic import synthetic_video_splits
from slotdiffusion_tpu_torch.models import build_model, init_random_
import torch_parallel_worker as worker

# the tolerances tests/test_torch_tp_fsdp.py holds Adam to under a plan:
# each parameter within PARAM_TOL of its scale, each kind of state within
# STATE_TOL of its largest value. A bf16 entry (adam_bf16's mu,
# adafactor's m) is rounded to bf16 after every update, and lands one
# rounding step from one process's wherever the f32 value it rounds
# straddles a boundary (the clip's global norm sums the shards in another
# order); momentum carries that step on while later updates cancel the
# value down, so a bf16 kind is held to a rounding step of its largest
# value, 2^-7 of it (the largest measured 5.6e-4 of it; every f32 kind
# within STATE_TOL).
PARAM_TOL = 1e-4
STATE_TOL = 3e-5
BF16_STEP = 2.0 ** -7
SHARDED_OPTIMIZERS = ("adam_fused", "adam_bf16", "adafactor")
UPDATES = 3
# trained parameters against one process's, over the largest parameter:
# the card's `SCALE_STATE_TOL` for Adam (chip_smoke.py)
TRAINED_TOL = 1e-3
# the losses and norms of steps after an update: the parameters moved
# apart as above (1.8e-5 the largest measured)
DRIFT_RTOL = 1e-4
# Adafactor alone: the sums over a sharded dimension are added in
# another order, and the update is g over the root of those statistics
UNIT_TOL = 1e-5
UNIT_CASES = {
    # (whole shape, flax_views layout, the dimension sharded over 2)
    "dense_largest": ((384, 256), "dense", 0),
    "dense_second": ((384, 256), "dense", 1),
    "conv_out": ((256, 130, 3, 3), "conv", 0),
    "conv_in": ((256, 130, 3, 3), "conv", 1),
    "conv_kernel": ((256, 130, 4, 3), "conv", 2),
    "deconv_out": ((130, 256, 3, 3), "deconv", 1),
    "unfactored": ((64, 256), "dense", 1),
    "bias": ((384,), None, 0),
    "packed_qkv": ((768, 256), ("qkv", 2), 0),
    "lstm_gates": ((512, 256), ("gates", 4), 1),
}
PLANS = {"tp2": dict(tp=2), "fsdp2": dict(tp=1, fsdp=True)}
# the optimizers whose state bytes are held at 2 ranks: Adam's moments and
# adafactor's statistics, which follow the shards by their own rule (every
# core at 4 ranks: tests/test_torch_aot.py)
BYTES_OPTIMIZERS = ("adam", "adafactor")


def _cfg(**kw):
    return configs.tiny_config().copy(
        train_batch_size=4, val_batch_size=4, max_epochs=2,
        warmup_steps_pct=0.0, use_ema=True, use_viz=False, print_iter=1,
        save_interval=100.0, save_epoch_end=False, async_ckpt=False, **kw)


def _weights(cfg):
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    return model.state_dict()


def _specs(tmp):
    """-> (the tasks of the 2-rank launch, those of the 1-process one)."""
    cfg = _cfg()
    weights = _weights(cfg)
    train, val = synthetic_video_splits(cfg, 4 * UPDATES, 4, 0)
    base = dict(cfg=cfg, weights=weights, train=train, val=val)
    accum = cfg.copy(grad_accum_steps=2)
    drawn = cfg.copy(use_viz=True)
    two, one = {}, {}
    for plan, kw in list(PLANS.items()) + [("one", {})]:
        tasks = one if plan == "one" else two
        tasks[f"optim_{plan}"] = dict(
            base, task="optim_grads", updates=UPDATES,
            optimizers=SHARDED_OPTIMIZERS, **kw)
        tasks[f"train_{plan}"] = dict(
            base, task="step", updates=UPDATES,
            optimizers=SHARDED_OPTIMIZERS, **kw)
        tasks[f"viz_{plan}"] = dict(base, task="viz", cfg=drawn,
                                    ckp=str(tmp / f"viz_{plan}"), **kw)
    for plan, kw in list(PLANS.items()) + [("dp2", {})]:
        two[f"bytes_{plan}"] = dict(base, task="state_bytes",
                                    optimizers=BYTES_OPTIMIZERS, **kw)
    for tasks, kw in ((two, dict(tp=2)), (one, {})):
        tasks["adafactor"] = dict(task="adafactor_shards", cases=UNIT_CASES,
                                  **kw)
    two["norms_tp2"] = dict(base, task="fit", cfg=accum, steps=2,
                            ckp=str(tmp / "norms_tp2"), tp=2)
    one["norms_one"] = dict(base, task="fit", cfg=accum, steps=2,
                            ckp=str(tmp / "norms_one"))
    # checkpointed at micro-step 3 (between the 2 micro-steps of the
    # second update), resumed to 4; and the uninterrupted run to 4
    cut = tmp / "cut"
    two["ckpt_cut"] = dict(base, task="fit", cfg=accum, steps=3,
                           ckp=str(cut), fsdp=True)
    two["ckpt_resumed"] = dict(base, task="fit", cfg=accum, steps=4,
                               ckp=str(tmp / "resumed"), fsdp=True,
                               resume=str(cut / "ckpt_last.pt"))
    two["ckpt_whole"] = dict(base, task="fit", cfg=accum, steps=4,
                             ckp=str(tmp / "whole"), fsdp=True)
    return two, one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the 2-rank results, one process's) by task key: one launch of
    each, side by side."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("scale_state")
    two, one = _specs(tmp)
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(worker.launch, dict(task="multi", tasks=tasks),
                            world, tmp, timeout=600)
                for tasks, world in ((two, 2), (one, 1))]
        return tuple(r.result()[0] for r in runs)


def _kinds(state):
    """{kind: [((parameter index, key), tensor)]} of an optimizer's
    whole state (adafactor's `v_row0`, `v_row1`... one kind)."""
    out = {}
    for i, st in state.items():
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim():
                out.setdefault(k.rstrip("0123456789"), []).append(
                    ((i, k), v))
    return out


def _assert_state_close(got, want, what):
    """Each kind of state within STATE_TOL of its largest value (a bf16
    kind within BF16_STEP of it)."""
    gk, wk = _kinds(got), _kinds(want)
    assert set(gk) == set(wk), what
    for kind, pairs in wk.items():
        scale = max(w.abs().max().item() for _, w in pairs)
        theirs = dict(gk[kind])
        for i, w in pairs:
            g = theirs[i]
            assert g.shape == w.shape and g.dtype == w.dtype, (what, kind)
            diff = (g.double() - w.double()).abs()
            room = (BF16_STEP if w.dtype == torch.bfloat16 else
                    STATE_TOL) * scale
            assert bool((diff <= room).all()), \
                f"{what} {kind} {i}: {diff.max().item():.3e} of {scale:.3e}"


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("name", SHARDED_OPTIMIZERS)
def test_optimizer_under_a_plan_matches_one_process(runs, name, plan):
    """3 updates of the tiny flagship's parameters under TP 2 or FSDP 2
    from the same seeded whole gradients one process takes (each rank its
    shards): each update's pre-clip norm to 1e-5 relative, the parameters
    within PARAM_TOL of their scale, the optimizer's whole state within
    STATE_TOL of each kind's largest value."""
    two, one = runs
    got, want = two[f"optim_{plan}"][name], one["optim_one"][name]
    assert len(want["norms"]) == UPDATES
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    for k, w in want["params"].items():
        g = got["params"][k]
        scale = max(w.abs().max().item(), 1e-6)
        assert (g - w).abs().max().item() <= PARAM_TOL * scale, \
            f"{name} {plan} {k}"
    key = "dm_decoder.unet.out.2.weight"
    assert not torch.equal(want["params"][key], _weights(_cfg())[key])
    _assert_state_close(_by_index(got["moments"]),
                        _by_index(want["moments"]), f"{name} {plan}")


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("name", SHARDED_OPTIMIZERS)
def test_training_under_a_plan_matches_one_process(runs, name, plan):
    """3 training steps of the tiny flagship under TP 2 or FSDP 2: the
    first step's loss and `train/grad_norm` to 1e-5 relative, the later
    ones' to DRIFT_RTOL, and the trained
    parameters within TRAINED_TOL of the largest parameter (the plan sums
    the gradients in another order, and these cores divide each element
    by its own root mean square, so an element whose gradient is
    rounding noise moves by a share of the LR either way; the moments
    are held above, on the same gradients)."""
    two, one = runs
    got, want = two[f"train_{plan}"], one["train_one"]
    assert got["plan"] == plan.rstrip("2")
    assert len(got[name]["metrics"]) == UPDATES
    for i, (g, w) in enumerate(zip(got[name]["metrics"],
                                   want[name]["metrics"])):
        for key in ("train/total_loss", "train/grad_norm"):
            np.testing.assert_allclose(g[key], w[key],
                                       rtol=1e-5 if i == 0 else DRIFT_RTOL,
                                       err_msg=f"{name} {plan} {key} {i}")
    pairs = [(got[name]["params"][k], w)
             for k, w in want[name]["params"].items()]
    diff = max((g - w).abs().max().item() for g, w in pairs)
    scale = max(w.abs().max().item() for _, w in pairs)
    assert diff <= TRAINED_TOL * scale, (name, plan, diff / scale)


def _by_index(moments):
    out = {}
    for (i, k), v in moments.items():
        out.setdefault(i, {})[k] = v
    return out


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_adafactor_sharded_statistics_match_one_process(runs, case):
    """A parameter sharded over 2 ranks along `case`'s dimension: after 3
    updates the parameter and every statistic (the factored row and
    column means, or the whole second moment; the bf16 momentum) equal
    one process's to UNIT_TOL of their scale."""
    two, one = runs
    (gp, gs), (wp, ws) = two["adafactor"][case], one["adafactor"][case]
    torch.testing.assert_close(gp, wp, rtol=0, atol=UNIT_TOL * wp.abs().max())
    assert set(gs) == set(ws) and len(ws) >= 2
    for k, w in ws.items():
        g = gs[k]
        assert g.shape == w.shape, (case, k)
        tol = (BF16_STEP if w.dtype == torch.bfloat16 else UNIT_TOL) * \
            w.double().abs().max()
        torch.testing.assert_close(g.double(), w.double(), rtol=0,
                                   atol=tol, msg=f"{case} {k}")


def test_grad_norm_of_every_micro_step_under_tp(runs):
    """TP 2 with `grad_accum_steps` 2: every micro-step logs the norm of
    its own gradient, one process's to 1e-5 relative."""
    two, one = runs
    got = {r["step"]: r["train/grad_norm"] for r in two["norms_tp2"]
           ["records"] if "train/grad_norm" in r}
    want = {r["step"]: r["train/grad_norm"] for r in one["norms_one"]
            ["records"] if "train/grad_norm" in r}
    assert sorted(got) == sorted(want) == [1, 2]
    for s in got:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-5,
                                   err_msg=f"step {s}")


def test_fsdp_checkpoint_between_micro_steps_resumes(runs):
    """FSDP 2, `grad_accum_steps` 2: a checkpoint at micro-step 3 holds
    the accumulated gradients (the mean over "data", whole); resumed, the
    run ends at the uninterrupted run's parameters and Adam's moments
    (PARAM_TOL, STATE_TOL), with the losses of step 4 equal."""
    two, _ = runs
    cut, resumed, whole = (two[k] for k in ("ckpt_cut", "ckpt_resumed",
                                            "ckpt_whole"))
    assert cut["plan"] == resumed["plan"] == "fsdp"
    assert cut["state"]["step"] == 3 and cut["state"]["optimizer"]["micro"]
    acc = cut["state"]["optimizer"]["acc"]
    assert acc and any(g is not None and g.abs().max() > 0 for g in acc)
    want = {r["step"]: r["train/total_loss"] for r in whole["records"]
            if "train/total_loss" in r}
    got = {r["step"]: r["train/total_loss"] for r in resumed["records"]
           if "train/total_loss" in r}
    assert sorted(got) == [4]
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5)
    a, b = resumed["state"], whole["state"]
    assert a["step"] == b["step"] == 4
    for k, w in b["model"].items():
        scale = max(w.abs().max().item(), 1e-6)
        assert (a["model"][k] - w).abs().max().item() <= PARAM_TOL * scale, k
    _assert_state_close(a["optimizer"]["core"]["state"],
                        b["optimizer"]["core"]["state"], "resumed")


@pytest.mark.parametrize("plan", list(PLANS))
def test_viz_of_a_sharded_model_is_one_process_viz(runs, plan):
    """The flagship's viz (its sampled videos, mask overlays and clip)
    drawn by rank 0 of a TP 2 or FSDP 2 run: the same files, byte for
    byte, as one process draws."""
    two, one = runs
    got, want = two[f"viz_{plan}"], one["viz_one"]
    assert want and sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, f"{plan} {name}"


@pytest.mark.parametrize("plan", ["dp2", "tp2", "fsdp2"])
def test_predicted_state_bytes_equal_the_live_state(runs, plan):
    """`parallel.aot.state_bytes` (the meta model and the plan's shard
    shapes) equals each rank's live parameters, optimizer state and EMA
    (local tensors) byte for byte, under Adam and adafactor."""
    two, _ = runs
    res = two[f"bytes_{plan}"]
    assert set(res) == set(BYTES_OPTIMIZERS)
    for name, r in res.items():
        pred = r["predicted"]
        assert len(r["live"]) == 2
        for rank, live in enumerate(r["live"]):
            assert live["params"] == pred["params"], (plan, name, rank)
            assert live["ema"] == pred["ema"], (plan, name, rank)
            assert live["opt"] == pred["opt"] + pred["opt_host"], \
                (plan, name, rank)
        if plan == "tp2":
            assert pred["replicated"]
        if plan == "dp2":
            assert pred["buckets"] > 0
