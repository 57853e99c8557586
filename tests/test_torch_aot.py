"""`slotdiffusion_tpu_torch.parallel.aot`, the port's per-card sizing of
the training step (the counterpart of the JAX package's parallel/aot.py,
tests/test_aot.py):

- the bytes it predicts from shard shapes (the model built on the meta
  device) equal each rank's live state (parameters, optimizer state, EMA:
  its local tensors) under every plan at 4 ranks and every optimizer, from
  one launch of 4 gloo worker processes (2 ranks:
  tests/test_torch_scale_state.py);
- its plan names are the JAX `_plan_name`'s for the same mesh shapes;
- `scripts/aot_scaling_torch.py --cpu` sizes the flagship on 4 and 8
  cards without a card (its invariants: FSDP's state a card below 0.6 of
  DP's, TP shards parameters; no activation peak made up), and the rows
  name the leaves the port keeps replicated where the JAX rule shards.
"""

import importlib.util

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from slotdiffusion_tpu.parallel.aot import _plan_name
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.data.synthetic import synthetic_video_splits
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.parallel import aot
from slotdiffusion_tpu_torch.training.optim import CORES
import torch_parallel_worker as worker

# (tp, fsdp) of each plan at 4 ranks
PLANS = {"dp4": (1, False), "dp2xtp2": (2, False), "dp4+fsdp": (1, True),
         "dp2xtp2+fsdp": (2, True)}


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """-> {plan: {optimizer: live bytes of each rank, predicted}}."""
    tmp = tmp_path_factory.mktemp("aot")
    cfg = configs.tiny_config().copy(train_batch_size=4, use_ema=True,
                                     use_viz=False)
    model = build_model(cfg, device="cpu")
    train, _ = synthetic_video_splits(cfg, 4, 0, 0)
    tasks = {plan: dict(task="state_bytes", cfg=cfg, tp=tp, fsdp=fsdp,
                        weights=model.state_dict(), train=train,
                        optimizers=CORES)
             for plan, (tp, fsdp) in PLANS.items()}
    res, _ = worker.launch(dict(task="multi", tasks=tasks), 4, tmp,
                           timeout=600)
    return res


@pytest.mark.parametrize("plan", list(PLANS))
def test_predicted_state_bytes_equal_the_live_state(live, plan):
    """Every rank's parameters, optimizer state and EMA, byte for byte, as
    `aot.state_bytes` predicts them for this plan and each optimizer; a
    sharded plan holds less than the replicated one."""
    for name, r in live[plan].items():
        assert len(r["live"]) == 4
        for rank, got in enumerate(r["live"]):
            pred = r["predicted"]
            assert got["params"] == pred["params"], (plan, name, rank)
            assert got["ema"] == pred["ema"], (plan, name, rank)
            assert got["opt"] == pred["opt"] + pred["opt_host"], \
                (plan, name, rank)
        if plan != "dp4":
            whole = live["dp4"][name]["predicted"]
            assert r["predicted"]["params"] < whole["params"]
            assert r["predicted"]["opt"] < whole["opt"]
            assert r["predicted"]["buckets"] == 0
    assert set(live[plan]) == set(CORES)


@pytest.mark.parametrize("data,model,fsdp", [
    (8, 1, False), (4, 2, False), (8, 1, True), (2, 4, True), (1, 8, False)])
def test_plan_names_are_the_jax_names(data, model, fsdp):
    devices = np.asarray(jax.devices()[:8]).reshape(data, model)
    mesh = Mesh(devices, axis_names=("data", "model"))
    assert aot.plan_name(data, model, fsdp) == _plan_name(mesh, fsdp)


def _script():
    spec = importlib.util.spec_from_file_location(
        "aot_scaling_torch", f"{worker.REPO}/scripts/aot_scaling_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def test_flagship_sizing_without_a_card(tmp_path, capsys):
    """The script on the CPU: 6 rows (DP, DP x TP 2, DP + FSDP on 4 and 8
    cards) at the flagship's global batch of 32, its invariants held, the
    activation peak null (not measured), the capacity an H100's; the rows
    as JSON lines in --out and the table printed."""
    out = tmp_path / "rows.jsonl"
    rows = _script().main(["--cpu", "--out", str(out)])
    assert [r["plan"] for r in rows] == [
        "dp4", "dp2xtp2", "dp4+fsdp", "dp8", "dp4xtp2", "dp8+fsdp"]
    assert len(out.read_text().splitlines()) == 6
    for r in rows:
        assert r["global_batch"] == 32 and \
            r["local_batch"] * r["data"] == 32
        assert r["activation_peak_per_card"] is None
        assert r["peak_per_card"] is None and r["fits"] is None
        assert r["hbm_per_card"] == 80 * 2 ** 30
    # DP's state does not change with the number of cards; FSDP's shrinks
    assert rows[0]["state_per_card"] == rows[3]["state_per_card"]
    assert rows[5]["state_per_card"] < rows[2]["state_per_card"]
    printed = capsys.readouterr().out
    assert "invariants OK" in printed and "| dp8+fsdp |" in printed


def test_rows_name_the_replicated_leaves_and_judge_the_fit():
    """The tiny flagship at TP 2 keeps its one-head attention's
    projections whole (the JAX rule shards them): the row names them and
    counts their bytes whole; with a measured peak the row sums it and
    judges the fit against the capacity."""
    cfg = configs.tiny_config()
    meta = build_model(cfg, device="meta")
    row = aot.size_plan(cfg, meta, 4, tp=2, global_batch=4,
                        activation_peak=1000, hbm=10 ** 12)
    assert len(row["replicated"]) == 24 and all(
        ".transformer_blocks.0.attn" in n for n in row["replicated"])
    assert row["peak_per_card"] == row["state_per_card"] + \
        row["batch_per_card"] + 1000
    assert row["fits"]
    tight = aot.size_plan(cfg, meta, 4, tp=2, global_batch=4,
                          activation_peak=1000, hbm=row["peak_per_card"])
    assert not tight["fits"]
    table = aot.format_table([row, tight]).splitlines()
    assert len(table) == 4 and "| 24 |" in table[2] and "| NO |" in table[3]
