"""The port's optimizer cores against optax and the JAX package's
`build_optimizer`, on the CPU.

`tests/test_torch_train.py::test_optimizer_matches_optax` holds every
core inside the whole chain (LR groups, clipping, accumulation). Here:
the choice of the core by name, the bf16 state of `adam_bf16` and
`adafactor` rounding where optax rounds it (bit for bit, on inputs both
sides see bit for bit), adafactor's factored dimensions on the JAX
layout of dense, conv and tied shapes, `adam_fused` against `adam`, the
state round trip, and the layouts of the port's models.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from slotdiffusion_tpu.training.optim import build_optimizer
from slotdiffusion_tpu_torch.convert import convert_model
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.training.optim import (CORES, Optimizer,
                                                    core_name, flax_layouts,
                                                    flax_views)
from torch_parity_helpers import (build_jax_model, images, is_video,
                                  jax_params_of, tiny_baseline_config,
                                  tiny_config, video)

# (JAX shape, port layout): a dense kernel [in, out], a conv kernel
# [kh, kw, C, F], a dense kernel whose two dimensions tie, one whose
# second dimension is below 128 (not factored) and a bias
SHAPES = {"dense": ((256, 160), "dense"), "conv": ((3, 3, 128, 192), "conv"),
          "tie": ((128, 128), "dense"), "small": ((96, 256), "dense"),
          "bias": ((160,), None)}
# optax's cores of the JAX package for the two bf16-state optimizers
OPTAX = {
    "adam_bf16": lambda lr: optax.adam(lr, mu_dtype=jnp.bfloat16),
    "adafactor": lambda lr: optax.adafactor(
        lr, min_dim_size_to_factor=128, multiply_by_parameter_scale=False,
        clipping_threshold=None, momentum=0.9, dtype_momentum=jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_port(a, layout):
    """A JAX-layout array -> the port's layout (the inverse of
    `flax_views` for a one-view layout)."""
    if layout == "dense":
        return np.ascontiguousarray(a.T)
    if layout == "conv":
        return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))
    return a.copy()


@pytest.mark.parametrize("name", ["adam_bf16", "adafactor"])
def test_bf16_state_cores_match_optax_bit_for_bit(name):
    """20 updates at a constant LR on the same gradients: adam_bf16's
    bf16 moment equal to optax's bit for bit and the parameters to 1e-6;
    adafactor's momentum within one bf16 ulp (see below), its f32
    statistics to 1e-6 relative, and row and column statistics exactly
    where optax keeps them, on the JAX shape (the tie: the row statistic
    over the JAX leaf's last dimension)."""
    r = np.random.RandomState(0)
    init = {k: r.randn(*s).astype(np.float32) for k, (s, _) in
            SHAPES.items()}
    lr = 1e-2
    tx = OPTAX[name](lr)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    params = {k: nn.Parameter(torch.from_numpy(_to_port(v, SHAPES[k][1])))
              for k, v in init.items()}
    opt = Optimizer(list(params.items()), lr=lr, total_steps=20,
                    warmup_steps=0, min_lr=lr, optimizer=name,
                    layouts={k: lay for k, (_, lay) in SHAPES.items()})
    for _ in range(20):
        g = {k: (r.randn(*v.shape) * r.choice([0.01, 1.0, 30.0])).astype(
            np.float32) for k, v in init.items()}
        # op by op, each rounding where optax's program says (a compiled
        # update fuses the moment's f32 sum: a bf16 flip in 1e-4 of the
        # elements; with XLA's excess precision on, its default, the
        # jitted `b1 * mu` stays f32: ROADMAP §3)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(_to_port(g[k], SHAPES[k][1]))
        opt.step()
    for k, p in params.items():
        lay = SHAPES[k][1]
        d = np.abs(flax_views(p.detach(), lay)[0].numpy() - np.asarray(jp[k]))
        st = opt.core.state[p]
        mom = st["mu" if name == "adam_bf16" else "m"]
        assert mom.dtype == torch.bfloat16
        mine = flax_views(mom.float(), lay)[0].numpy()
        if name == "adam_bf16":
            want = state[0].mu[k]
        else:
            want = next(s for s in state if hasattr(s, "ema")).ema[k]
        assert want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        if name == "adam_bf16":
            np.testing.assert_array_equal(mine, want, err_msg=k)
            assert d.max() <= 1e-6 * (1 + np.abs(np.asarray(jp[k])).max()), k
            continue
        # adafactor's f32 update differs from XLA's by an ulp in places
        # (its means sum in another order, x^-1/2 rounds otherwise), which
        # flips a bf16 rounding of the momentum now and then; the flip
        # decays through later steps (0.9 m), so it is held at the
        # tensor's scale: under 0.1 % of the elements differ, each by at
        # most 4 bf16 ulps of the largest, and a parameter is away from
        # optax's by more than 1e-6 only there, by under 5 % of one
        # step's LR (an update reaches ~3 LR where the gradient's scale
        # jumps, and a bf16 flip moves it by 2^-8)
        assert (mine != want).mean() <= 1e-3, k
        assert np.abs(mine - want).max() <= 2.0 ** -5 * np.abs(want).max(), k
        assert (d > 1e-6).mean() <= 1e-3 and d.max() <= 0.05 * lr, k
        if name != "adafactor":
            continue
        fac = state[0]
        factored = k in ("dense", "conv", "tie")
        assert ("v_row0" in st) == factored and ("v0" in st) != factored
        for key in (("v_row", "v_col") if factored else ("v",)):
            np.testing.assert_allclose(st[f"{key}0"].numpy(),
                                       np.asarray(getattr(fac, key)[k]),
                                       rtol=1e-6, err_msg=(k, key))


def test_core_choice_follows_build_optimizer():
    """The lower-cased name picks the core; `weight_decay > 0` selects
    adamw whatever the name, as the JAX `build_optimizer` does; an unknown
    name raises ValueError on both sides."""
    assert [core_name(n.upper()) for n in CORES] == list(CORES)
    assert core_name("Adam") == "adam"
    assert core_name("sgd", 0.01) == "adamw"
    assert core_name("no_such_optimizer", 0.01) == "adamw"
    kinds = {"adam": torch.optim.Adam, "adam_fused": torch.optim.Adam,
             "adamw": torch.optim.AdamW, "sgd": torch.optim.SGD}
    p = nn.Parameter(torch.zeros(3))
    for name in CORES:
        opt = Optimizer([("w", p)], lr=1e-3, total_steps=1, warmup_steps=0,
                        optimizer=name)
        assert opt.name == name
        if name in kinds:
            assert type(opt.core) is kinds[name]
    for ctor in (lambda: build_optimizer({"w": jnp.zeros(3)}, lr=1e-3,
                                         total_steps=1, warmup_steps=0,
                                         optimizer="adamax"),
                 lambda: Optimizer([("w", p)], lr=1e-3, total_steps=1,
                                   warmup_steps=0, optimizer="adamax")):
        with pytest.raises(ValueError, match="adamax"):
            ctor()


def test_weight_decay_selects_adamw_against_optax():
    """optimizer="sgd" with weight_decay 0.01: both sides train adamw
    (decaying every parameter, biases too); 10 updates to 1e-6."""
    r = np.random.RandomState(3)
    init = {"w": r.randn(5, 4).astype(np.float32),
            "b": r.randn(4).astype(np.float32)}
    kw = dict(lr=1e-2, total_steps=10, warmup_steps=2, optimizer="sgd",
              weight_decay=0.01)
    tx, _ = build_optimizer(init, **kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    params = {k: nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = Optimizer(list(params.items()), **kw)
    assert opt.name == "adamw"
    for _ in range(10):
        g = {k: r.randn(*v.shape).astype(np.float32)
             for k, v in init.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _run(name, steps, state=None, start=0):
    """Updates `start` to `start + steps` of `name` (clip 1, 2 micro-
    batches an update, each micro-batch's gradients drawn from its index)
    on seeded tensors, from `state` when given; -> (params, optimizer)."""
    r = np.random.RandomState(0)
    params = {k: nn.Parameter(torch.from_numpy(
        _to_port(r.randn(*s).astype(np.float32), lay)))
        for k, (s, lay) in SHAPES.items()}
    opt = Optimizer(list(params.items()), lr=1e-2, total_steps=10,
                    warmup_steps=1, clip_grad=1.0, grad_accum_steps=2,
                    optimizer=name,
                    layouts={k: lay for k, (_, lay) in SHAPES.items()})
    if state is not None:
        for p, v in zip(params.values(), state["params"]):
            p.data.copy_(v)
        opt.load_state_dict(state["optimizer"])
    for micro in range(2 * start, 2 * (start + steps)):
        g = torch.Generator().manual_seed(100 + micro)
        for p in params.values():
            d = torch.randn(p.shape, generator=g) * opt.backward_scale()
            p.grad = d if p.grad is None else p.grad + d
        opt.step()
    return params, opt


@pytest.mark.parametrize("name", CORES)
def test_state_round_trip(name):
    """3 updates, the state through torch.save / load(weights_only=True),
    a new optimizer loads it and takes 3 more: the parameters equal an
    uninterrupted 6 updates' bit for bit; bf16 moments stay bf16."""
    whole, _ = _run(name, 6)
    params, opt = _run(name, 3)
    buf = io.BytesIO()
    torch.save({"params": [p.detach() for p in params.values()],
                "optimizer": opt.state_dict()}, buf)
    buf.seek(0)
    state = torch.load(buf, weights_only=True)
    assert state["optimizer"]["name"] == name
    resumed, opt2 = _run(name, 3, state=state, start=3)
    for k in whole:
        assert torch.equal(whole[k], resumed[k]), (name, k)
    for st in opt2.core.state.values():
        for key in ("mu", "m"):
            if key in st:
                assert st[key].dtype == torch.bfloat16


def test_state_from_before_the_cores_loads():
    """An optimizer state written before the other cores (Adam's under
    "adam", no name) resumes into an adam optimizer; another core
    refuses it."""
    params, opt = _run("adam", 2)
    state = opt.state_dict()
    old = {"adam": state["core"], "micro": state["micro"],
           "count": state["count"], "acc": state["acc"]}
    p2, opt2 = _run("adam", 0)
    opt2.load_state_dict(old)
    assert opt2.count == opt.count
    for a, b in zip(opt.core.state.values(), opt2.core.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
    _, sgd = _run("sgd", 0)
    with pytest.raises(ValueError, match="adam"):
        sgd.load_state_dict(old)


def test_adam_fused_equals_adam():
    """torch.optim.Adam(fused=True) against the default Adam: 10 updates
    of the chain, within 1e-6 relative."""
    a, _ = _run("adam", 10)
    b, _ = _run("adam_fused", 10)
    for k in a:
        np.testing.assert_allclose(b[k].detach().numpy(),
                                   a[k].detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("which", ["flagship", "SAVi_lstm", "SLATE"])
def test_flax_layouts_view_every_tensor_as_its_jax_leaf(which):
    """Each JAX leaf of a tiny model gets values unique to it (shapes by
    jax.eval_shape, nothing compiled), is converted into the port's model,
    and every view `flax_views` takes of a port tensor with a layout is
    one whole JAX leaf, with its shape: the dense, conv, transposed conv,
    packed attention (q/k/v, biases, output) and LSTM gate layouts."""
    lstm = dict(pred_type="transformer", pred_rnn=True, pred_num_layers=1,
                pred_num_heads=2, pred_ffn_dim=64, pred_norm_first=True)
    cfg = {"flagship": lambda: tiny_config(use_pallas=False),
           "SAVi_lstm": lambda: tiny_baseline_config("SAVi", pred_dict=lstm),
           "SLATE": lambda: tiny_baseline_config("SLATE")}[which]()
    jmodel = build_jax_model(jax_params_of(cfg))
    x = video() if is_video(cfg.model) else images()
    rngs = {n: jax.random.PRNGKey(i) for i, n in enumerate(
        ("params", "diffusion", "dropout", "gumbel"))}
    shapes = jax.eval_shape(
        lambda r, x: jmodel.init(r, {"img": x}, method=jmodel.compute_losses),
        rngs, jnp.asarray(x))["params"]
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    start, filled = 1, []
    for s in leaves:
        filled.append(np.arange(start, start + int(np.prod(s.shape)),
                                dtype=np.float64).reshape(s.shape))
        start += int(np.prod(s.shape))
    assert start < 2 ** 24  # exact in f32
    by_first = {int(a.flat[0]): a for a in filled}
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert_model(
        jax.tree_util.tree_unflatten(tree, filled), cfg))
    layouts = flax_layouts(model)
    kinds = {v if isinstance(v, str) else v[0] for v in layouts.values()}
    want = {"flagship": {"dense", "conv", "qkv", "qkv_bias", "attn_out"},
            "SAVi_lstm": {"dense", "conv", "deconv", "gates", "qkv"},
            "SLATE": {"dense", "conv"}}[which]
    assert want <= kinds, kinds
    sd = dict(model.named_parameters())
    for name, layout in layouts.items():
        for v in flax_views(sd[name].detach(), layout):
            if layout == "deconv":  # the port flips the kernel spatially
                v = v.flip(0, 1)
            leaf = by_first.get(int(v.flatten()[0]))
            assert leaf is not None, name
            assert tuple(v.shape) == leaf.shape, name
            np.testing.assert_array_equal(v.double().numpy(), leaf,
                                          err_msg=name)
