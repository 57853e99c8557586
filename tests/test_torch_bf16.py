"""The port in bf16 (`use_bf16`) against the JAX package in bf16, on the CPU.

One seeded set of f32 weights goes, converted, into both packages' modules,
each built twice: computing in bf16 (`use_bf16=True`, the JAX
`params.use_bf16`) and in f32. The same numpy inputs go through them.
The JAX side is compiled with XLA's `xla_allow_excess_precision` off, so
that it rounds where its program says (on, XLA skips the rounding of a
bf16 value that is widened to f32 at once, as every GroupNorm input is).
Distances are root-mean-square over the output (max-abs is printed too):

    d     = |port16 - jax16|   the port in bf16 against the JAX model in bf16
    floor = |jax16 - jax32|    the bf16 noise floor
    own   = |port16 - port32|  how far the port's own bf16 moves it
    ctl   = |port32 - jax16|   the control: the port computing in f32

Per layer (Dense, Conv, LayerNorm, GroupNorm+SiLU, attention on both
backends, ResBlock, SpatialTransformer, GEGLU) the port rounds where flax
does, so `d <= LAYER_C * floor`: LAYER_C = 0.1 where the readings are 0
(bit-identical here; the ResBlock 0.006), and 0.6 for the two that hold
the tanh GELU (readings 0.44 and 0.50: torch evaluates it in f32 and
rounds once, XLA on the CPU rounds after each of its nine ops). The
control must fail that gate, `ctl > LAYER_C * floor` (readings 1.0): a
port that computed in f32, or rounded elsewhere, would not pass.

Whole-model outputs (encode's slots and masks, denoise, the loss, one
DPM-Solver++ step) cannot be held that close: a difference of delta below
one bf16 ulp becomes one of ~sqrt(delta * ulp) at the next rounding, so
the f32 sum-order differences of a few layers grow to the size of the
floor. There `d <= WHOLE_C * floor`, WHOLE_C = 2 (readings: slots 1.05,
masks 0.68, denoise 0.69, the loss over 12 noise draws 1.73), and the
port must round as much as the JAX model does, `ROUNDS[0] * floor <= own
<= ROUNDS[1] * floor` with ROUNDS = (0.5, 2) (readings 0.68-1.71): that
is the control, since the f32 port has own = 0. Each output also has an
absolute max-abs bound, a few times the distances measured here. The
loss's 1.73 is its inputs' rounding, not its own path's: on the JAX
bf16 model's slots and latents the port's loss path sits at 0.85
(`test_loss_distance_comes_from_the_inputs_not_the_unet`).

Also: `use_pallas="auto"` resolves to the f32 formula on every device, as
in the JAX package; the bf16 output conv has an f32 output and the JAX
`_conv3x3_bf16_acc_f32` gradients; a Trainer step keeps the parameters
and Adam's state f32.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.models import blocks as jax_blocks
from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.models import unet as jax_unet
from slotdiffusion_tpu.models.unet import GEGLU as JaxGEGLU
from slotdiffusion_tpu.models.unet import _conv3x3_bf16_acc_f32
from slotdiffusion_tpu_torch import convert
from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.models import build_model, init_random_
from slotdiffusion_tpu_torch.models import blocks
from slotdiffusion_tpu_torch.models import slot_attention as port_sa
from slotdiffusion_tpu_torch.models import unet
from slotdiffusion_tpu_torch.models.unet import GEGLU, ConvOutBf16Acc
from torch_parity_helpers import (ROUNDS, SLOT_SIZE, SLOTS, T_FRAMES,
                                  WHOLE_C, build_pair, jax_params_of,
                                  random_params, t2n, tiny_config, video)

BF16 = torch.bfloat16
# the gates of the module docstring
LAYER_C = {"exact": 0.1, "activation": 0.6}
DRAWS = 12  # of the loss's latent noise


@pytest.fixture(scope="module")
def models():
    """JAX and port models, in bf16 and in f32, on the same weights."""
    cfg, jax16, jvars, port16 = build_pair(use_bf16=True)
    jax32 = build_jax_model(jax_params_of(tiny_config()))
    port32 = build_model(tiny_config(), device="cpu")
    port32.load_state_dict(port16.state_dict(), strict=True)
    return dict(cfg=cfg, jax16=jax16, jax32=jax32, jvars=jvars,
                port16=port16, port32=port32)


def xla(fn, *args):
    """fn(*args) compiled by XLA with `xla_allow_excess_precision` off, so
    it rounds where the JAX program says (with it on, XLA may skip the
    rounding of a bf16 value that is widened again at once)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax(models, which, fn, *args):
    m = models[which]
    return xla(lambda v, *a: m.apply(v, *a, method=fn), models["jvars"],
               *[jnp.asarray(a) for a in args])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _distances(port16, port32, jax16, jax32):
    p16, p32, j16, j32 = map(_f32, (port16, port32, jax16, jax32))
    rms = lambda a, b: float(np.sqrt(np.mean((a - b) ** 2)))
    return dict(d=rms(p16, j16), floor=rms(j16, j32), own=rms(p16, p32),
                ctl=rms(p32, j16), max_d=float(np.abs(p16 - j16).max()))


def _show(name, r):
    ratio = lambda k: r[k] / r["floor"] if r["floor"] else float("nan")
    print(f"{name}: rms d {r['d']:.4g}, floor {r['floor']:.4g}, own "
          f"{r['own']:.4g}, ctl {r['ctl']:.4g}; d/floor {ratio('d'):.3f}, "
          f"own/floor {ratio('own'):.3f}, ctl/floor {ratio('ctl'):.3f}; "
          f"max-abs d {r['max_d']:.4g}")


def check(name, port16, port32, jax16, jax32, bound):
    """The whole-model gate of the module docstring on one output. Where
    the floor is 0 (quantized outputs, the same on both JAX sides), the
    port must give them too, to f32 rounding."""
    r = _distances(port16, port32, jax16, jax32)
    _show(name, r)
    assert r["max_d"] <= bound, name
    if r["floor"] == 0:
        assert r["max_d"] <= 1e-6 and r["own"] == 0, name
        return
    assert r["d"] <= WHOLE_C * r["floor"], name
    assert ROUNDS[0] * r["floor"] <= r["own"] <= ROUNDS[1] * r["floor"], \
        name


def check_layer(name, port16, port32, jax16, jax32, kind="exact"):
    """The per-layer gate of the module docstring, with its control."""
    r = _distances(port16, port32, jax16, jax32)
    _show(name, r)
    c = LAYER_C[kind]
    assert r["floor"] > 0, name
    assert r["d"] <= c * r["floor"], name
    assert r["ctl"] > c * r["floor"], f"{name}: the control passes"


def test_parameters_are_f32_and_load_an_f32_state_dict(models):
    """bf16 computes, the parameters stay f32 under the f32 model's names,
    and an f32 state_dict loads strictly."""
    port16, port32 = models["port16"], models["port32"]
    assert all(p.dtype == torch.float32 for p in port16.parameters())
    assert list(port16.state_dict()) == list(port32.state_dict())
    fresh = build_model(tiny_config(use_bf16=True), device="cpu")
    fresh.load_state_dict(port32.state_dict(), strict=True)


class _Port(torch.nn.Module):
    """A port layer under the name `m` (its state_dict keys "m.*"), taking
    and giving NHWC when `nchw` (the JAX layout)."""

    def __init__(self, m, nchw):
        super().__init__()
        self.m, self.nchw = m, nchw

    def forward(self, x, *extra):
        if self.nchw:
            return self.m(x.permute(0, 3, 1, 2).contiguous(),
                          *extra).permute(0, 2, 3, 1)
        return self.m(x, *extra)


_ST = dict(channels=64, num_heads=2, head_dim=32, depth=1, context_dim=32,
           attn_backend="fused")
# name -> (JAX module of a dtype, port module of a dtype, converter of its
# params into "m.*", input shape (NHWC where `nchw`), extra input shapes
# (given in f32: the ResBlock's time embedding, whose SiLU torch evaluates
# in one rounding and XLA in four), nchw, gate)
LAYERS = {
    "Dense": (lambda d: fnn.Dense(64, dtype=d),
              lambda d: blocks.Linear(48, 64, compute_dtype=d),
              lambda sd, p: convert._linear(sd, "m", p),
              (4, 40, 48), (), False, "exact"),
    "Conv3x3": (lambda d: fnn.Conv(32, (3, 3), dtype=d),
                lambda d: blocks.Conv2d(32, 32, 3, padding=1,
                                        compute_dtype=d),
                lambda sd, p: convert._conv(sd, "m", p),
                (2, 8, 8, 32), (), True, "exact"),
    "LayerNorm": (lambda d: fnn.LayerNorm(epsilon=1e-5, dtype=d),
                  lambda d: blocks.LayerNorm(48, compute_dtype=d),
                  lambda sd, p: convert._layernorm(sd, "m", p),
                  (4, 40, 48), (), False, "exact"),
    "GroupNorm+SiLU": (
        lambda d: jax_blocks.GroupNorm32(act="silu", fused=True, dtype=d),
        lambda d: blocks.GroupNorm32(64, act="silu", fused=True),
        lambda sd, p: convert._norm(sd, "m", p),
        (2, 8, 8, 64), (), True, "exact"),
    **{f"CrossAttention-{be}": (
        lambda d, be=be: jax_unet.CrossAttention(64, 32, 2, 32,
                                                 attn_backend=be, dtype=d),
        lambda d, be=be: unet.CrossAttention(64, 32, 2, 32, be, "fast",
                                             compute_dtype=d),
        lambda sd, p: [convert._linear(sd, f"m.{n}", p[n])
                       for n in ("to_q", "to_k", "to_v")] and
        convert._linear(sd, "m.to_out.0", p["to_out"]),
        (4, 16, 64), ((4, 5, 32),), False, "exact")
        for be in ("einsum", "fused")},
    "ResBlock": (lambda d: jax_unet.ResBlock(32, fused_gn=True, dtype=d),
                 lambda d: unet.ResBlock(64, 32, 64, fused_gn=True,
                                         compute_dtype=d),
                 lambda sd, p: convert._resblock(sd, "m", p),
                 (2, 8, 8, 64), ((2, 64),), True, "exact"),
    "SpatialTransformer": (
        lambda d: jax_unet.SpatialTransformer(**_ST, fused_gn=True, dtype=d),
        lambda d: unet.SpatialTransformer(*_ST.values(), "fast", True,
                                          compute_dtype=d),
        lambda sd, p: convert._spatial_transformer(sd, "m", p, 1),
        (2, 8, 8, 64), ((2, 5, 32),), True, "activation"),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_rounds_as_jax_bf16(name):
    """One layer of each kind the bf16 model runs, on seeded f32 weights
    and bf16-valued inputs given in the compute dtype on both sides: the
    per-layer gate of the module docstring, with its control."""
    jax_mod, port_mod, conv, shape, extra, nchw, kind = LAYERS[name]
    r = np.random.RandomState(6)
    args = [r.randn(*s).astype(np.float32) for s in (shape, *extra)]
    f32_args = name == "ResBlock"
    params = random_params(jax.eval_shape(
        jax_mod(jnp.float32).init, jax.random.PRNGKey(0),
        *map(jnp.asarray, args))["params"])
    sd = {}
    conv(sd, params)
    out = {}
    for dt, jdt in ((BF16, jnp.bfloat16), (torch.float32, jnp.float32)):
        tag = f"{dt.itemsize * 8}"
        jargs = [jnp.asarray(a).astype(jnp.float32 if i and f32_args
                                        else jdt) for i, a in enumerate(args)]
        out["jax" + tag] = xla(jax_mod(jdt).apply, {"params": params},
                               *jargs)
        port = _Port(port_mod(dt), nchw)
        port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                              for k, v in sd.items()}, strict=True)
        with torch.no_grad():
            out["port" + tag] = port(*[torch.from_numpy(np.asarray(
                a.astype(jnp.float32))).to(a.dtype == jnp.float32 and
                                           torch.float32 or dt)
                for a in jargs])
    assert out["port16"].dtype == BF16
    check_layer(name, out["port16"], out["port32"], out["jax16"],
                out["jax32"], kind)


def test_encode_matches_jax_bf16(models):
    """Slots come out in bf16 and masks in f32, as the JAX model's."""
    img = video(0, B=2)
    want = {k: _jax(models, k, lambda m, x: m({"img": x}, train=False), img)
            for k in ("jax16", "jax32")}
    with torch.no_grad():
        got = {k: models[k]({"img": torch.from_numpy(img)})
               for k in ("port16", "port32")}
    assert got["port16"]["slots"].dtype == BF16
    assert want["jax16"]["slots"].dtype == jnp.bfloat16
    assert got["port16"]["masks"].dtype == torch.float32
    assert want["jax16"]["masks"].dtype == jnp.float32
    for key, bound in (("slots", 0.03), ("masks", 1e-3)):
        check(f"encode {key}", got["port16"][key], got["port32"][key],
              want["jax16"][key], want["jax32"][key], bound)


def _unet_inputs(seed=1):
    r = np.random.RandomState(seed)
    slots = r.randn(2 * T_FRAMES, SLOTS, SLOT_SIZE).astype(np.float32)
    x = r.randn(2 * T_FRAMES, 4, 4, 3).astype(np.float32)
    t = (np.arange(2 * T_FRAMES) * 11).astype(np.int32)
    noise = r.randn(*x.shape).astype(np.float32)
    return slots, x, t, noise


def test_denoise_matches_jax_bf16(models):
    """The UNet in bf16 with its output conv in f32 (the default
    `conv_out_compute`): an f32 output on both sides."""
    slots, x, t, _ = _unet_inputs()
    fn = lambda m, x, t, c: m.dm_decoder.denoise(x, t, c)
    want = {k: _jax(models, k, fn, x, t, slots) for k in ("jax16", "jax32")}
    with torch.no_grad():
        got = {k: models[k].dm_decoder.denoise(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(slots))
            for k in ("port16", "port32")}
    assert got["port16"].dtype == torch.float32
    assert want["jax16"].dtype == jnp.float32
    check("denoise", got["port16"], got["port32"], want["jax16"],
          want["jax32"], 0.2)


def test_compute_losses_matches_jax_bf16(models):
    """The denoising loss of 2 clips at fixed timesteps and latent noise:
    encode, VQ-VAE encode, q_sample and the UNet in bf16, the loss in f32.
    The JAX side composes q_sample + denoise itself (its `make_rng` draws
    can never equal a torch.Generator's). One loss is one sample of the
    rounding noise, so the gate holds the losses of DRAWS draws of the
    timesteps and noise."""
    img = video(0, B=2)
    draws = [_unet_inputs(seed)[2:] for seed in range(2, 2 + DRAWS)]

    def f(m, img, t, noise):
        out = m({"img": img}, train=True)
        dm = m.dm_decoder
        x0 = dm.encode_latent(img.reshape(-1, *img.shape[2:]))
        pred = dm.denoise(dm.q_sample(x0, t, noise), t,
                          context=out["slots"].reshape(-1, SLOTS, SLOT_SIZE),
                          train=False)
        return jnp.mean((pred.astype(jnp.float32) - noise) ** 2)

    want = {}
    for k in ("jax16", "jax32"):
        m = models[k]
        fn = lambda v, *a: m.apply(v, *a, method=f)
        args = (models["jvars"], jnp.asarray(img))
        loss = jax.jit(fn).lower(*args, *map(jnp.asarray, draws[0])).compile(
            compiler_options={"xla_allow_excess_precision": False})
        want[k] = np.array([loss(*args, *map(jnp.asarray, dr))
                            for dr in draws])
    got = {}
    for k in ("port16", "port32"):
        got[k] = []
        for t, noise in draws:
            with torch.no_grad():
                _, losses = models[k].compute_losses(
                    {"img": torch.from_numpy(img)},
                    t=torch.from_numpy(t).long(),
                    noise=torch.from_numpy(noise), train=False)
            assert losses["denoise_loss"].dtype == torch.float32
            got[k].append(losses["denoise_loss"].item())
        got[k] = np.array(got[k])
    check("denoise_loss", got["port16"], got["port32"], want["jax16"],
          want["jax32"], 0.02)


def test_loss_distance_comes_from_the_inputs_not_the_unet(models):
    """Where the whole-model loss distance (1.73 of the floor over the
    DRAWS draws) comes from. The loss reads two inputs computed once from
    the clip: the slots (encode) and the VQ-VAE's latents x0. Each of the
    port's sits about one floor from the JAX model's (slots 1.05, x0
    1.10): held block by block, no layer leaves the floor, the distance
    grows a little at every bf16 rounding (the GN-ResNet's blocks 0.05,
    0.18, 0.29, 0.37, 0.44, 0.49 of their floors, its head 0.54), so the
    two packages' roundings of these inputs end up about as independent
    as bf16 and f32 are. Given the JAX model's own bf16 slots and latents,
    the port's bf16 q_sample + UNet + loss stay inside the floor (reading
    0.85): the excess is the inputs' independent rounding, not a layer of
    the loss path."""
    img = video(0, B=2)
    draws = [_unet_inputs(seed)[2:] for seed in range(2, 2 + DRAWS)]

    def inputs(m, img):
        slots = m({"img": img}, train=True)["slots"]
        return slots, m.dm_decoder.encode_latent(
            img.reshape(-1, *img.shape[2:]))

    def loss_from(m, slots, x0, t, noise):
        dm = m.dm_decoder
        pred = dm.denoise(dm.q_sample(x0, t, noise), t,
                          context=slots.reshape(-1, SLOTS, SLOT_SIZE),
                          train=False)
        return jnp.mean((pred.astype(jnp.float32) - noise) ** 2)

    losses = {}
    for k in ("jax16", "jax32"):
        m = models[k]
        slots, x0 = _jax(models, k, inputs, img)
        fn = jax.jit(lambda v, *a: m.apply(v, *a, method=loss_from)).lower(
            models["jvars"], slots, x0, *map(jnp.asarray, draws[0])).compile(
            compiler_options={"xla_allow_excess_precision": False})
        losses[k] = np.array([fn(models["jvars"], slots, x0,
                                 *map(jnp.asarray, dr)) for dr in draws])
        if k == "jax16":
            j_slots = torch.from_numpy(np.array(_f32(slots))).to(BF16)
            j_x0 = torch.from_numpy(np.array(_f32(x0)))
    dm = models["port16"].dm_decoder
    got = []
    for t, noise in draws:
        t, noise = torch.from_numpy(t).long(), torch.from_numpy(noise)
        with torch.no_grad():
            pred = dm.denoise(dm.q_sample(j_x0, t, noise), t,
                              j_slots.reshape(-1, SLOTS, SLOT_SIZE))
        got.append(((pred.float() - noise) ** 2).mean().item())
    floor = np.sqrt(np.mean((losses["jax16"] - losses["jax32"]) ** 2))
    d = np.sqrt(np.mean((np.array(got) - losses["jax16"]) ** 2))
    print(f"loss on the JAX bf16 model's slots and latents: d/floor "
          f"{d / floor:.3f}")
    assert 0 < floor and d <= floor


def test_one_dpm_solver_step_matches_jax_bf16(models):
    """One first-order DPM-Solver++ step from the same x_T with
    quantize-as-denoise: the sampler's state is f32 on both sides. The one
    step lands on t ~ 0, where the result is the quantized x0 prediction:
    codebook entries, the same on all four sides unless a code flips."""
    slots, _, _, x_T = _unet_inputs(3)

    def fn(m, c, x):
        return m.dm_decoder.sample_dpm(jax.random.PRNGKey(0), cond=c,
                                       steps=1, order=1, x_T=x)

    want = {k: _jax(models, k, fn, slots, x_T) for k in ("jax16", "jax32")}
    got = {}
    for k in ("port16", "port32"):
        with torch.no_grad():
            got[k] = models[k].dm_decoder.sample_dpm(
                cond=torch.from_numpy(slots), steps=1, order=1,
                x_T=torch.from_numpy(x_T))
    assert got["port16"].dtype == torch.float32
    check("one DPM-Solver++ step", got["port16"], got["port32"],
          want["jax16"], want["jax32"], 1.0)


class _ReportsCuda(torch.Tensor):
    """A CPU tensor whose `.device` says cuda (results of torch functions
    on it keep the class), so the device-dependent branch of a module is
    taken without a card."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_auto_resolves_to_the_f32_formula(device_type, monkeypatch):
    """`use_pallas="auto"` runs slot attention's f32 formula (kv in f32),
    never the kernel `sa_iterations`, whatever the device type, as the JAX
    package's "auto" does (models/slot_attention.py:133-137 there)."""
    calls = []

    def kernel(*args, **kwargs):
        calls.append("kernel")
        raise AssertionError("auto launched the kernel")

    ref = port_sa.sa_iterations_ref

    def f32_formula(k, v, slots, p, **kw):
        calls.append(("f32", kw["kv_dtype"]))
        plain = lambda t: t.as_subclass(torch.Tensor)
        return ref(plain(k), plain(v), plain(slots),
                   {key: plain(val) for key, val in p.items()}, **kw)

    monkeypatch.setattr(port_sa, "sa_iterations", kernel)
    monkeypatch.setattr(port_sa, "sa_iterations_ref", f32_formula)
    sa = port_sa.SlotAttention(in_features=16, num_iterations=2,
                               slot_size=16, mlp_hidden_size=32,
                               return_last_attn=True, use_pallas="auto")
    init_random_(sa, torch.Generator().manual_seed(0))
    inputs = torch.randn(2, 20, 16, generator=torch.Generator().manual_seed(1))
    slots = torch.randn(2, 3, 16, generator=torch.Generator().manual_seed(2))
    if device_type == "cuda":
        inputs, slots = inputs.as_subclass(_ReportsCuda), \
            slots.as_subclass(_ReportsCuda)
        assert inputs.float().device.type == "cuda"
    with torch.no_grad():
        out, mask = sa(inputs, slots)
    assert calls == [("f32", torch.float32)]
    assert out.shape == (2, 3, 16) and mask.shape == (2, 3, 20)


def test_geglu_takes_the_tanh_gelu_under_bf16():
    """The port's GEGLU against the JAX GEGLU on the same weights: the
    exact erf GELU in f32 (to f32 rounding), the tanh form in bf16 (the
    per-layer gate of the module docstring)."""
    r = np.random.RandomState(4)
    x = r.randn(3, 5, 32).astype(np.float32)
    w = (r.randn(32, 256) / np.sqrt(32)).astype(np.float32)
    b = (0.1 * r.randn(256)).astype(np.float32)
    out = {}
    for dtype, approximate in ((torch.float32, "none"), (BF16, "tanh")):
        port = GEGLU(32, 128, compute_dtype=dtype)
        assert port.approximate == approximate
        with torch.no_grad():
            port.proj.weight.copy_(torch.from_numpy(w.T))
            port.proj.bias.copy_(torch.from_numpy(b))
            out[f"port{dtype.itemsize * 8}"] = port(torch.from_numpy(x))
        jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
        out[f"jax{dtype.itemsize * 8}"] = JaxGEGLU(128, dtype=jdt).apply(
            {"params": {"Dense_0": {"kernel": jnp.asarray(w),
                                    "bias": jnp.asarray(b)}}},
            jnp.asarray(x))
    assert out["port16"].dtype == BF16 and out["jax16"].dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(out["port32"]), _f32(out["jax32"]),
                               rtol=1e-5, atol=1e-5)
    check_layer("GEGLU", out["port16"], out["port32"], out["jax16"],
                out["jax32"], "activation")


def test_bf16_output_conv_matches_jax():
    """`conv_out_compute="bf16"`: bf16 operands, an f32 output (the f32
    sums of exact products, as JAX's f32 accumulation: f32 rounding
    apart), and the gradients of the bf16 conv on the bf16-cast cotangent
    (one bf16 ulp apart where the roundings differ)."""
    r = np.random.RandomState(5)
    x = r.randn(2, 6, 6, 32).astype(np.float32)
    w = (r.randn(3, 3, 32, 3) / 17).astype(np.float32)
    b = (0.1 * r.randn(3)).astype(np.float32)
    g = r.randn(2, 6, 6, 3).astype(np.float32)
    x16, w16 = jnp.asarray(x).astype(jnp.bfloat16), \
        jnp.asarray(w).astype(jnp.bfloat16)
    y, vjp = jax.vjp(_conv3x3_bf16_acc_f32, x16, w16)
    gx, gw = vjp(jnp.asarray(g))
    conv = ConvOutBf16Acc(32, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16).requires_grad_()
    out = conv(xt)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(t2n(out.permute(0, 2, 3, 1)),
                               np.asarray(y) + b, rtol=1e-5, atol=1e-5)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    assert xt.grad.dtype == BF16 and conv.weight.grad.dtype == torch.float32
    tol = dict(rtol=2.0 ** -7, atol=1e-3)
    np.testing.assert_allclose(_f32(xt.grad.permute(0, 2, 3, 1)), _f32(gx),
                               **tol)
    np.testing.assert_allclose(t2n(conv.weight.grad.permute(2, 3, 1, 0)),
                               _f32(gw), **tol)
    np.testing.assert_allclose(t2n(conv.bias.grad), g.sum((0, 1, 2)),
                               rtol=1e-5)


def test_trainer_step_keeps_f32_master_weights():
    """A Trainer step of the bf16 model: the parameters, their gradients
    and Adam's moments stay f32, the parameters move, and the logged
    grad norm is the f32 gradient's."""
    cfg = tiny_config(use_bf16=True)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    data = SyntheticVideoData(cfg, 2, num_samples=4, seed=0)
    trainer = build_method(model, data, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    model.train()
    for batch in data.train_loader(0, 0):  # the first step's LR is 0
        metrics = trainer.train_step(batch)
    assert np.isfinite(metrics["train/grad_norm"])
    assert np.isfinite(metrics["train/denoise_loss"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    moments = [t for st in trainer.optimizer.core.state.values()
               for t in st.values() if torch.is_tensor(t) and t.dim()]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    moved = [n for n, p in model.named_parameters()
             if n in before and not torch.equal(p, before[n])]
    assert len(moved) > len(before) // 2
