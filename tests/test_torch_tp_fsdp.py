"""Tensor parallelism and FSDP in the port (`slotdiffusion_tpu_torch.
parallel.tp`) against the JAX package's rules (parallel/tp.py), and the
sharded training step against the replicated one, on the CPU over gloo.

- The rule counts: on the tiny SAViDiffusion, SLATE and STEVE the port
  shards exactly the leaves the JAX rules shard (mapped through
  `convert.py`'s walks, leaf by leaf), less the attention projections
  whose head count does not divide the TP size, which the port keeps
  replicated and the test names; `tp_param_count` and
  `fsdp_param_count` equal the JAX ones up to those leaves.
- GEGLU's fused projection: rank r's rows are [h_r; gate_r].
- One step at TP = 2, FSDP = 2 and TP x FSDP = 2 x 2 (4 ranks) against
  the replicated step: loss and `train/grad_norm` to 1e-5 relative,
  every parameter SGD updated within 1e-5 of its scale (an update linear
  in the gradient), every parameter Adam updated within ADAM_TOL, the
  EMA shadow (laid out as its parameter) the same.
- STEVE's and SLATE's K/V-cached greedy `generate` under TP = 2 gives the
  replicated run's ids.

The multi-process cases read one module fixture's runs (three worker
launches side by side). Every other optimizer under TP and FSDP:
tests/test_torch_scale_state.py.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from slotdiffusion_tpu.parallel.mesh import make_mesh as jax_mesh
from slotdiffusion_tpu.parallel.tp import fsdp_augment, fsdp_param_count, \
    param_spec, tp_param_count
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import convert_model
from slotdiffusion_tpu_torch.data.synthetic import synthetic_video_splits
from slotdiffusion_tpu_torch.models import build_model, init_random_
from slotdiffusion_tpu_torch.parallel import tp as ptp
from torch_parallel_worker import launch
from torch_parity_helpers import SLOT_SIZE, SLOTS, build_pair, \
    tiny_baseline_config

# the tiny SAViDiffusion's level-0 attentions have one head of 32: under
# TP = 2 the port keeps their projections replicated (the JAX rule
# shards the 32-wide width)
REPLICATED_TP2 = sorted(
    f"dm_decoder.unet.{blk}.1.transformer_blocks.0.{attn}.{proj}.weight"
    for blk in ("input_blocks.1", "output_blocks.2", "output_blocks.3")
    for attn in ("attn1", "attn2")
    for proj in ("to_q", "to_k", "to_v", "to_out.0"))
# the AR decoders' 2 heads do not split over TP = 4
REPLICATED_AR_TP4 = sorted(
    f"trans_decoder.tf_dec.blocks.{i}.{attn}.{proj}.weight"
    for i in range(2) for attn in ("self_attn", "encoder_decoder_attn")
    for proj in ("proj_q", "proj_k", "proj_v", "proj_o"))


def _configs():
    return {"SAViDiffusion": configs.tiny_config(use_pallas=False),
            "SLATE": tiny_baseline_config("SLATE"),
            "STEVE": tiny_baseline_config("STEVE")}


@pytest.fixture(scope="module")
def pairs():
    return {name: build_pair(cfg=cfg) for name, cfg in _configs().items()}


def _leaf_map(params, cfg):
    """{port parameter name: the JAX leaf paths it is made of}: every JAX
    leaf filled with its own index, carried through `convert_model`."""
    flat, tree = jax.tree_util.tree_flatten_with_path(params)
    ids = jax.tree_util.tree_unflatten(tree, [
        np.full(np.shape(leaf), i, np.float32)
        for i, (_, leaf) in enumerate(flat)])
    paths = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in flat]
    return {name: {paths[int(i)] for i in np.unique(t.numpy())}
            for name, t in convert_model(ids, cfg).items()}


def _jax_sharded(params, tp, data):
    """(the JAX leaves TP shards over "model", those FSDP shards over
    "data") by path."""
    model, fsdp = set(), set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        base = param_spec(path, leaf, tp) if tp > 1 else P()
        if base != P():
            model.add(name)
        if "data" in fsdp_augment(base, leaf, data):
            fsdp.add(name)
    return model, fsdp


@pytest.mark.parametrize("name,tp,data,replicated", [
    ("SAViDiffusion", 2, 4, REPLICATED_TP2),
    ("SAViDiffusion", 1, 8, []),
    ("SLATE", 2, 4, []),
    ("STEVE", 2, 4, []),
    ("STEVE", 4, 2, REPLICATED_AR_TP4),
])
def test_port_shards_the_leaves_the_jax_rules_shard(pairs, name, tp, data,
                                                     replicated):
    cfg, _, jvars, tmodel = pairs[name]
    params = jvars["params"]
    leaves = _leaf_map(params, cfg)
    jax_model, jax_fsdp = _jax_sharded(params, tp, data)
    sizes = {n: p.numel() for n, p in tmodel.named_parameters()}
    styles, kept = ptp.tp_styles(tmodel, tp)
    port_model = set(ptp._tp_sharded(styles)) & set(sizes)
    kept = sorted(f"{m}.weight" for m in kept)
    assert kept == replicated
    # the port's TP leaves are the JAX rules' less the kept ones, leaf for
    # leaf through the conversion
    want = {n for n, src in leaves.items() if src & jax_model}
    assert all(len(leaves[n]) == 1 for n in want)
    assert port_model == want - set(kept) and set(kept) <= want
    mesh = jax_mesh(data=data, model=tp)
    assert ptp.tp_param_count(tmodel, tp) + sum(
        sizes[n] for n in kept) == tp_param_count(params, mesh)
    # FSDP: the same leaves over "data", where TP lays them out alike
    port_fsdp = set(ptp.fsdp_dims(tmodel, data, ptp._tp_sharded(styles)))
    want_fsdp = {n for n, src in leaves.items() if src & jax_fsdp}
    assert port_fsdp - set(kept) == want_fsdp - set(kept)
    if not kept:
        assert ptp.fsdp_param_count(tmodel, data, tp) == \
            fsdp_param_count(params, mesh)
    if tp > 1:
        assert port_model


def test_geglu_rows_give_each_rank_its_halves():
    """The permutation puts [h_r; gate_r] in rank r's block of rows, so the
    local `chunk(2)` of a column-parallel GEGLU is right."""
    width, tp = 8, 4
    rows = torch.arange(2 * width)  # h rows 0..7, gate rows 8..15
    permuted = rows[ptp.geglu_perm(2 * width, tp)]
    for r, block in enumerate(permuted.chunk(tp)):
        h, gate = block.chunk(2)
        assert h.tolist() == list(range(r * 2, r * 2 + 2))
        assert gate.tolist() == list(range(width + r * 2, width + r * 2 + 2))
    assert torch.equal(permuted[torch.argsort(ptp.geglu_perm(16, tp))], rows)


# ---- one step of each plan against the replicated step -------------------


# Adam's first update is lr g / (|g| + eps): where a gradient is small,
# the f32 difference of another reduction order moves its update by a
# share of the LR (6.5e-7 of a ResBlock conv bias at LR 1e-4, 1.45e-5 of
# its scale, under TP = 2)
ADAM_TOL = 1e-4
STEP_TOL = {"sgd": 1e-5, "adam": ADAM_TOL}
# Adam's moments of one step, each kind over its largest value in the
# model (a bias before a GroupNorm has a gradient of rounding noise, so
# its moments have no scale of their own); the largest measured 4.06e-6
# (exp_avg_sq under TP 2 x FSDP 2)
MOMENT_TOL = 3e-5


def _step_spec():
    cfg = configs.tiny_config().copy(
        train_batch_size=4, val_batch_size=4, max_epochs=2,
        warmup_steps_pct=0.0, use_ema=True, use_viz=False)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    train, _ = synthetic_video_splits(cfg, 8, 0, 0)
    return dict(task="step", cfg=cfg, weights=model.state_dict(),
                train=train, optimizers=("sgd", "adam"))


def _generate_spec(name):
    """Greedy generation of `name` (STEVE or SLATE) under TP 2, from
    seeded slots -> (the spec, the model it starts from)."""
    cfg = _configs()[name].copy(use_viz=False)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    slots = torch.randn(2, SLOTS, SLOT_SIZE,
                        generator=torch.Generator().manual_seed(1))
    if name == "STEVE":
        train, _ = synthetic_video_splits(cfg, 4, 0, 0)
    else:
        from slotdiffusion_tpu_torch.data import build_dataset
        train, _ = build_dataset(cfg)
    return dict(task="generate", cfg=cfg, weights=model.state_dict(),
                train=train, slots=slots, gen_steps=16, tp=2), model


# each plan's world and layout
PLAN_RUNS = {"tp2": (2, dict(tp=2, fsdp=False)),
             "fsdp2": (2, dict(tp=1, fsdp=True)),
             "tp2xfsdp2": (4, dict(tp=2, fsdp=True))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The file's runs across processes, three launches side by side:
    the replicated step in one process, the 2-rank plans and generations,
    the 4-rank plan. -> {task: rank 0's result}."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("tp_fsdp")
    launches = {1: {"replicated": _step_spec()}, 2: {}, 4: {}}
    for name, (world, kw) in PLAN_RUNS.items():
        launches[world][name] = dict(_step_spec(), **kw)
    for name in ("STEVE", "SLATE"):
        launches[2][f"generate_{name}"] = _generate_spec(name)[0]
    with ThreadPoolExecutor(len(launches)) as pool:
        done = [pool.submit(launch, dict(task="multi", tasks=tasks), world,
                            tmp, timeout=600)
                for world, tasks in launches.items()]
        out = {}
        for r in done:
            out.update(r.result()[0])
    return out


@pytest.mark.parametrize("world,tp,fsdp,kind", [
    (2, 2, False, "tp"), (2, 1, True, "fsdp"), (4, 2, True, "tp+fsdp")],
    ids=["tp2", "fsdp2", "tp2xfsdp2"])
def test_plan_step_matches_the_replicated_step(runs, world, tp, fsdp,
                                               kind):
    replicated_step = runs["replicated"]
    name = {(2, False): "tp2", (1, True): "fsdp2", (2, True): "tp2xfsdp2"}[
        tp, fsdp]
    assert PLAN_RUNS[name] == (world, dict(tp=tp, fsdp=fsdp))
    res = runs[name]
    assert res["plan"] == kind
    if tp > 1:
        assert res["styles"] and sorted(
            f"{m}.weight" for m in res["replicated"]) == REPLICATED_TP2
    if fsdp:
        assert res["fsdp_dims"]
    start = _step_spec()["weights"]
    for opt, tol in STEP_TOL.items():
        want, got = replicated_step[opt]["metrics"], res[opt]["metrics"]
        assert want["lr"] > 0
        for key in ("train/total_loss", "train/grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=f"{opt} {key}")
        for part in ("params", "ema"):
            for name, w in replicated_step[opt][part].items():
                g = res[opt][part][name]
                scale = max(w.abs().max().item(), 1e-6)
                assert (g - w).abs().max().item() <= tol * scale, \
                    f"{opt} {part} {name}"
        assert not torch.equal(
            replicated_step[opt]["params"]["dm_decoder.unet.out.2.weight"],
            start["dm_decoder.unet.out.2.weight"])
        # the optimizer's state, whole, at the one process's indices: each
        # moment within MOMENT_TOL of its largest value over the model
        want, got = replicated_step[opt]["moments"], res[opt]["moments"]
        assert set(got) == set(want) and (opt == "sgd" or want)
        for kind in {k for _, k in want}:
            pairs = [(got[key], w) for key, w in want.items()
                     if key[1] == kind]
            diff = max((g - w).abs().max().item() for g, w in pairs)
            scale = max(w.abs().max().item() for _, w in pairs)
            assert diff <= MOMENT_TOL * scale, f"{opt} {kind}"


# ---- K/V-cached generation under TP ---------------------------------------


@pytest.mark.parametrize("name", ["STEVE", "SLATE"])
def test_tp_generate_gives_the_replicated_ids(name, runs):
    spec, model = _generate_spec(name)
    two = runs[f"generate_{name}"]
    with torch.no_grad():
        ids, logits = model.trans_decoder.generate(spec["slots"], 16)
    assert two["heads"] == [1, 1] and [
        blk.self_attn.num_heads
        for blk in model.trans_decoder.tf_dec.blocks] == [2, 2]
    assert torch.equal(two["ids"], ids)
    torch.testing.assert_close(two["logits"], logits, rtol=1e-5,
                               atol=1e-5)
