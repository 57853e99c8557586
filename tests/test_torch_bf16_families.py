"""bf16 (`use_bf16`) of the image family and the baselines against the JAX
package in bf16, on the CPU, with `tests/test_torch_bf16.py`'s method and
gates (imported from it, unchanged): per layer `d <= LAYER_C * floor`
with the f32 control failing it; whole-model outputs `d <= WHOLE_C *
floor` and `ROUNDS[0] * floor <= own <= ROUNDS[1] * floor`, the JAX side
compiled with `xla_allow_excess_precision` off.

Per layer, the layer types only these families have: the transposed
convolution in the compute dtype (the spatial broadcast decoder), the
dVAE's conv block with its f32 one-group norm, one AR-decoder block, the
LSTM cell of the recurrent predictor and the readout's pair MLP (its
`linear2` f32). Whole models: SA (slots, masks, recon), SADiffusion
(slots, the denoise), SAVi with the transformer and with the LSTM
predictor (slots, masks) and the dVAE (logits, recon);
`tests/test_torch_bf16_token_vp.py` holds SLATE, STEVE, SADiffusion with
DINO, the readout and LDMSlotFormer. The max-abs bound of each output is
a few times its reading.

Readings (d / floor; `-s` prints them): every layer here 0 (bit-identical;
the LSTM cell sat at 0.947 with torch's one-rounding sigmoid, and rounds
as `jax.nn.sigmoid` does since: `models/blocks.py:sigmoid`); SA slots 0,
masks 1.18, recon 0.63; SADiffusion slots 0.54, denoise 0.97; SAVi slots
0 with either predictor, masks 1.18 (transformer) and 0.94 (LSTM); the
dVAE's logits 0, recon 0.20.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.models import ar_decoder as jar
from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.models import dvae as jdvae
from slotdiffusion_tpu.models import readout as jreadout
from slotdiffusion_tpu_torch import convert
from slotdiffusion_tpu_torch.models import ar_decoder, blocks, build_model
from slotdiffusion_tpu_torch.models import dvae as tdvae
from slotdiffusion_tpu_torch.models import predictor as tpred
from slotdiffusion_tpu_torch.models import readout as treadout
from test_torch_bf16 import BF16, _Port, _f32, check, check_layer, xla
from torch_parity_helpers import (SLOT_SIZE, SLOTS, build_pair, images,
                                  jax_params_of, random_params,
                                  tiny_baseline_config, tiny_image_config,
                                  video)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- per layer ---------------------------------------------------------------

class _ARBlock(torch.nn.Module):
    """The port's AR-decoder block as the JAX block is called: (x,
    memory), the causal mask and the cross-attention's memory K/V made
    here as the decoder makes them."""

    def __init__(self, d, heads, dt):
        super().__init__()
        self.m = ar_decoder.ARDecoderBlock(d, heads, 0.5, False, dt)

    def forward(self, x, memory):
        ca = self.m.encoder_decoder_attn
        causal = torch.ones(x.shape[1], x.shape[1], dtype=torch.bool).triu(1)
        return self.m(x, (ca.proj_k(memory), ca.proj_v(memory)), causal)


class _JaxARBlock(fnn.Module):
    dtype: jnp.dtype

    @fnn.compact
    def __call__(self, x, memory):
        causal = jnp.triu(jnp.ones((x.shape[1],) * 2, bool), k=1)[None, None]
        return jar.ARDecoderBlock(32, 2, 0.5, False, dtype=self.dtype,
                                  name="m")(x, memory, causal)


class _Cell(torch.nn.Module):
    """One step of the LSTM predictor's cell (`RNNPredictorWrapper._cell`)
    on (c, h, x): -> [c', h'] stacked."""

    def __init__(self, dt, hidden=48):
        super().__init__()
        self.m = tpred.RNNPredictorWrapper(torch.nn.Identity(), SLOT_SIZE,
                                           hidden, compute_dtype=dt)

    def forward(self, x, c, h):
        return torch.stack(self.m._cell(0, (c, h), x))


class _JaxCell(fnn.Module):
    dtype: jnp.dtype

    @fnn.compact
    def __call__(self, x, c, h):
        (c, h), _ = fnn.OptimizedLSTMCell(48, dtype=self.dtype,
                                          name="lstm0")((c, h), x)
        return jnp.stack([c, h])


def _lstm(sd, p):
    tree = {"base": {}, "lstm0": p["lstm0"],
            "out_proj": {"kernel": np.zeros((48, SLOT_SIZE), np.float32),
                         "bias": np.zeros(SLOT_SIZE, np.float32)}}
    for k, v in convert.convert_rnn_predictor(tree, lambda b: {}).items():
        sd[f"m.m.{k}"] = v


def _ar_block(sd, p):
    """The JAX block's params -> the port block's names under "m.m." (the
    decoder's walk, its other entries dummies)."""
    dummy = {"kernel": np.zeros((1, 1), np.float32)}
    tree = {"in_proj": dummy, "head": dummy, "block0": p["m"],
            "tok_emb": {"embedding": np.zeros((1, 1), np.float32)},
            "pos_emb": np.zeros(1, np.float32),
            "final_ln": {"scale": np.zeros(1), "bias": np.zeros(1)}}
    pre = "tf_dec.blocks.0."
    for k, v in convert.convert_ar_decoder(tree).items():
        if k.startswith(pre):
            sd[f"m.m.{k[len(pre):]}"] = v


READOUT = dict(num_slots=4, slot_size=SLOT_SIZE, agg_func="max",
               feats_dim=48)


class _Readout(torch.nn.Module):
    def __init__(self, dt):
        super().__init__()
        self.m = treadout.PhysionReadout(READOUT, compute_dtype=dt)

    def forward(self, slots):
        return self.m({"slots": slots})["logits"]


class _JaxReadout(fnn.Module):
    dtype: jnp.dtype

    @fnn.compact
    def __call__(self, slots):
        return jreadout.PhysionReadout(READOUT, dtype=self.dtype, name="m")(
            {"slots": slots})["logits"]


def _conv_block(sd, p):
    convert._conv(sd, "m.m", p["Conv_0"], bias=False)
    sd["m.weight"] = np.asarray(p["GroupNorm_0"]["scale"])
    sd["m.bias"] = np.asarray(p["GroupNorm_0"]["bias"])


# name -> (JAX module of a dtype, port module of a dtype, converter of its
# params into the port's "m.*" names, input shapes (NHWC where `nchw`;
# each given in the compute dtype), nchw)
LAYERS = {
    "ConvTranspose2d": (
        lambda d: fnn.ConvTranspose(16, (5, 5), strides=(2, 2),
                                    padding=((2, 3), (2, 3)), dtype=d),
        lambda d: blocks.ConvTranspose2d(32, 16, 5, 2, padding=2,
                                         output_padding=1, compute_dtype=d),
        lambda sd, p: convert._deconv(sd, "m", p),
        ((2, 4, 4, 32),), True),
    "dVAE Conv2dBlock": (
        lambda d: jdvae.Conv2dBlock(32, 3, 1, dtype=d),
        lambda d: tdvae.Conv2dBlock(16, 32, 3, 1, compute_dtype=d),
        _conv_block, ((2, 8, 8, 16),), True),
    "ARDecoderBlock": (
        lambda d: _JaxARBlock(d), lambda d: _ARBlock(32, 2, d), _ar_block,
        ((2, 10, 32), (2, SLOTS, 32)), False),
    "LSTM cell": (
        lambda d: _JaxCell(d), lambda d: _Cell(d), _lstm,
        ((6, SLOT_SIZE), (6, 48), (6, 48)), False),
    "readout pair MLP": (
        lambda d: _JaxReadout(d), lambda d: _Readout(d),
        lambda sd, p: [convert._linear(sd, f"m.m.{n}", p["m"][n])
                       for n in ("linear1", "linear2")],
        ((2, 3, 4, SLOT_SIZE),), False),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_family_layer_rounds_as_jax_bf16(name):
    """One layer of each kind only these families run, on seeded f32
    weights and bf16-valued inputs given in the compute dtype on both
    sides: the per-layer gate, with its control."""
    jax_mod, port_mod, conv, shapes, nchw = LAYERS[name]
    r = np.random.RandomState(7)
    args = [r.randn(*s).astype(np.float32) for s in shapes]
    params = random_params(jax.eval_shape(
        jax_mod(jnp.float32).init, jax.random.PRNGKey(0),
        *map(jnp.asarray, args))["params"])
    sd = {}
    conv(sd, params)
    out = {}
    for dt, jdt in ((BF16, jnp.bfloat16), (torch.float32, jnp.float32)):
        tag = f"{dt.itemsize * 8}"
        jargs = [jnp.asarray(a).astype(jdt) for a in args]
        out["jax" + tag] = xla(jax_mod(jdt).apply, {"params": params},
                               *jargs)
        port = _Port(port_mod(dt), nchw)
        port.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                              for k, v in sd.items()}, strict=True)
        with torch.no_grad():
            out["port" + tag] = port(*[torch.from_numpy(np.asarray(
                a.astype(jnp.float32))).to(dt) for a in jargs])
    check_layer(name, out["port16"], out["port32"], out["jax16"],
                out["jax32"])


# ---- whole models ------------------------------------------------------------

def quad(cfg, data=None):
    """The JAX model and the port's, each in bf16 and in f32, on one
    seeded set of f32 weights: {"jax16", "jax32", "jvars", "port16",
    "port32"}. A model whose init takes other inputs than images or clips
    (the slot models) is initialized through its `__call__` on `data`."""
    cfg16, cfg32 = cfg.copy(use_bf16=True), cfg.copy(use_bf16=False)
    jp = {}
    for c in (cfg16, cfg32):
        jp[c.use_bf16] = jax_params_of(c)
        for k in ("rollout_dict", "readout_dict"):
            if hasattr(c, k):
                setattr(jp[c.use_bf16], k, getattr(c, k))
    if data is None:
        _, jax16, jvars, port16 = build_pair(cfg=cfg16)
    else:
        jax16 = build_jax_model(jp[True])
        shapes = jax.eval_shape(lambda r, d: jax16.init(r, d), {
            "params": jax.random.PRNGKey(0),
            "diffusion": jax.random.PRNGKey(1)},
            {k: jnp.asarray(v) for k, v in data.items()})
        params = random_params(shapes["params"])
        jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
        port16 = build_model(cfg16, device="cpu")
        port16.load_state_dict(convert.convert_model(params, cfg16),
                               strict=True)
    port32 = build_model(cfg32, device="cpu")
    port32.load_state_dict(port16.state_dict(), strict=True)
    return dict(jax16=jax16, jax32=build_jax_model(jp[False]), jvars=jvars,
                port16=port16.eval(), port32=port32.eval())


def run(q, jax_fn, port_fn, *args):
    """`jax_fn` (a method of the JAX model) and `port_fn(model, *tensors)`
    on the four models: {"jax16", "jax32", "port16", "port32"}."""
    out = {}
    for k in ("jax16", "jax32"):
        m = q[k]
        out[k] = xla(lambda v, *a: m.apply(v, *a, method=jax_fn), q["jvars"],
                     *map(jnp.asarray, args))
    for k in ("port16", "port32"):
        with torch.no_grad():
            out[k] = port_fn(q[k], *map(torch.from_numpy, args))
    return out


def check_all(out, keys, bounds, what):
    for key in keys:
        pick = (lambda o: o[key]) if key is not None else (lambda o: o)
        check(f"{what} {key or ''}".strip(), *(pick(out[k]) for k in (
            "port16", "port32", "jax16", "jax32")), bounds[key])


def test_sa_matches_jax_bf16():
    """SA on 2 images: slots, masks and the reconstruction (the spatial
    broadcast decoder's transposed convolutions in bf16)."""
    q = quad(tiny_image_config("SA"))
    out = run(q, lambda m, x: m({"img": x}, train=False),
              lambda m, x: m({"img": x}, train=False), images(3))
    check_all(out, ("slots", "masks", "recon_img"),
              {"slots": 0.01, "masks": 0.01, "recon_img": 0.01}, "SA")


def test_sadiffusion_matches_jax_bf16():
    """SADiffusion: the slots of 2 images, then the UNet's denoise of
    their latents from the same noisy input and slots (f32 output)."""
    q = quad(tiny_image_config("SADiffusion"))
    out = run(q, lambda m, x: m({"img": x}, train=False)["slots"],
              lambda m, x: m({"img": x}, train=False)["slots"], images(4))
    check_all(out, (None,), {None: 0.02}, "SADiffusion slots")
    r = np.random.RandomState(5)
    slots = r.randn(2, SLOTS, SLOT_SIZE).astype(np.float32)
    x = r.randn(2, 4, 4, 3).astype(np.float32)
    t = np.array([3, 8], np.int32)
    out = run(q, lambda m, x, t, c: m.dm_decoder.denoise(x, t, c),
              lambda m, x, t, c: m.dm_decoder.denoise(x, t, c), x, t, slots)
    check_all(out, (None,), {None: 0.2}, "SADiffusion denoise")


LSTM = dict(pred_type="transformer", pred_rnn=True, pred_num_layers=1,
            pred_num_heads=2, pred_ffn_dim=48, pred_norm_first=True)


@pytest.mark.parametrize("pred", ["transformer", "lstm"])
def test_savi_matches_jax_bf16(pred):
    """SAVi over 3 frames of 2 clips, the predictor between frames (the
    transformer, or the LSTM around it): slots and masks."""
    q = quad(tiny_baseline_config(
        "SAVi", pred_dict=LSTM if pred == "lstm" else None))
    fn = lambda m, x: m({"img": x}, train=False)
    out = run(q, fn, fn, video(6, B=2, T=3))
    check_all(out, ("slots", "masks"), {"slots": 0.01, "masks": 0.01},
              f"SAVi ({pred})")


def test_dvae_matches_jax_bf16():
    """The dVAE on 2 images: the token logits (its one-group norms in
    f32) and the eval forward's reconstruction (the softmax at tau 0.3)."""
    q = quad(tiny_baseline_config("dVAE"))
    img = images(8)
    out = run(q, lambda m, x: m.encode_logits(x),
              lambda m, x: m.encode_logits(x), img)
    check_all(out, (None,), {None: 1e-3}, "dVAE logits")
    sched = {"gumbel_tau": 0.3}
    out = run(q, lambda m, x: m.compute_losses({"img": x}, sched, False)[0],
              lambda m, x: m.compute_losses({"img": x}, train=False,
                                            sched=sched)[0], img)
    check_all(out, ("recon",), {"recon": 0.05}, "dVAE")
