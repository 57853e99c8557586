"""bf16 (`use_bf16`) of SLATE, STEVE, SADiffusion with the frozen DINO
ViT, the Physion readout and LDMSlotFormer against the JAX package in
bf16, on the CPU, under `tests/test_torch_bf16.py`'s whole-model gate
(imported from it, unchanged; the per-layer gates of these families'
layers are in `tests/test_torch_bf16_families.py`): `d <= WHOLE_C *
floor` and `ROUNDS[0] * floor <= own <= ROUNDS[1] * floor`, the JAX side
compiled with `xla_allow_excess_precision` off. The max-abs bound of
each output is a few times its reading.

Readings (d / floor; `-s` prints them): SLATE slots and logits 0; STEVE
slots 0.86 and logits 0.96 (its GN-ResNet, as the flagship's, drifts a
little at every bf16 rounding); the DINO ViT's features 1.02; SADiffusion
with DINO slots 0.67; the readout's logits 0; LDMSlotFormer's decode step
1.12 (own 1.50).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.models import dino as jax_dino
from slotdiffusion_tpu_torch.convert import convert_dino
from slotdiffusion_tpu_torch.models import dino
from test_torch_bf16 import BF16, check, xla
from test_torch_bf16_families import check_all, quad, run
from test_torch_dino_slice import tiny_dino_config
from test_torch_slotformer import TINY_ROLLOUT, _slotformer_config
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, T_FRAMES, VOCAB,
                                  images, random_params,
                                  tiny_baseline_config, video)

PATCHES = 16  # the tiny dVAE's 4x4 tokens of a 16x16 image


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ids(seed, *shape):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (*shape, PATCHES)).astype(np.int32)


def _teacher_forced(m, img, ids):
    out = m({"img": img, "token_id": ids}, train=False)
    return {"slots": out["slots"], "logits": out["pred_token_id"]}


def test_slate_matches_jax_bf16():
    """SLATE on 2 images: the slots, and the AR decoder's teacher-forced
    logits (f32) of one shared token sequence."""
    q = quad(tiny_baseline_config("SLATE"))
    out = run(q, _teacher_forced, _teacher_forced, images(9), _ids(1, 2))
    check_all(out, ("slots", "logits"), {"slots": 1e-3, "logits": 1e-3},
              "SLATE")


def test_steve_matches_jax_bf16():
    """STEVE on 2 clips of 2 frames: the slots (SAVi with its transformer
    predictor) and the teacher-forced logits of shared tokens."""
    q = quad(tiny_baseline_config("STEVE"))
    out = run(q, _teacher_forced, _teacher_forced, video(10, B=2),
              _ids(2, 2, T_FRAMES))
    check_all(out, ("slots", "logits"), {"slots": 0.05, "logits": 0.1},
              "STEVE")


def test_dino_encoder_matches_jax_bf16():
    """The whole frozen DINO ViT-S/8 (12 blocks of 384) on 2 images of
    16x16, on seeded weights: its patch features in bf16."""
    img = images(11)
    jm = {d: jax_dino.DINOEncoder(patch_size=8, dtype=d)
          for d in (jnp.bfloat16, jnp.float32)}
    params = random_params(jax.eval_shape(
        jm[jnp.float32].init, jax.random.PRNGKey(0),
        jnp.asarray(img))["params"], 3)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in convert_dino(params).items()}
    out = {}
    for dt, jdt in ((BF16, jnp.bfloat16), (torch.float32, jnp.float32)):
        tag = f"{dt.itemsize * 8}"
        x = jnp.asarray(img).astype(jdt)
        out["jax" + tag] = xla(jm[jdt].apply, {"params": params}, x)
        port = dino.DINOEncoder(RES, 8, compute_dtype=dt)
        port.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out["port" + tag] = port.eval()(torch.from_numpy(np.asarray(
                x.astype(jnp.float32))).to(dt))
    assert out["port16"].dtype == BF16
    check("DINO features", out["port16"], out["port32"], out["jax16"],
          out["jax32"], 0.3)


def test_sadiffusion_with_dino_matches_jax_bf16():
    """SADiffusion over the frozen DINO ViT: the slots of 2 images."""
    q = quad(tiny_dino_config())
    fn = lambda m, x: m({"img": x}, train=False)["slots"]
    out = run(q, fn, fn, images(12))
    check_all(out, (None,), {None: 0.02}, "SADiffusion (DINO) slots")


READOUT = dict(num_slots=5, slot_size=SLOT_SIZE, agg_func="max",
               feats_dim=48)


def test_readout_matches_jax_bf16():
    """The Physion readout over 4 clips of 6 frames of 5 slots: its
    logits (the pair MLP in bf16, `linear2` in f32)."""
    from slotdiffusion_tpu_torch import configs
    cfg = configs.ReadoutSynthetic().copy(readout_dict=READOUT)
    slots = np.random.RandomState(13).randn(
        4, 6, 5, SLOT_SIZE).astype(np.float32)
    q = quad(cfg, data={"slots": slots})
    fn = lambda m, s: m({"slots": s}, train=False)["logits"]
    out = run(q, fn, fn, slots)
    assert out["port16"].dtype == torch.float32
    check_all(out, (None,), {None: 1e-3}, "readout logits")


def test_ldm_slotformer_decode_step_matches_jax_bf16():
    """LDMSlotFormer's frozen LDM: one first-order DPM-Solver++ step from
    a shared x_T conditioned on 4 frames' slots (quantize-as-denoise, as
    the flagship's step in tests/test_torch_bf16.py)."""
    r = np.random.RandomState(14)
    slots = r.randn(4, SLOTS, SLOT_SIZE).astype(np.float32)
    x_T = r.randn(4, 4, 4, 3).astype(np.float32)
    q = quad(_slotformer_config("LDMSlotFormer"), data={
        "slots": r.randn(2, TINY_ROLLOUT["history_len"] + 3, SLOTS,
                         SLOT_SIZE).astype(np.float32)})
    out = run(q, lambda m, c, x: m.dm_decoder.sample_dpm(
        jax.random.PRNGKey(0), cond=c, steps=1, order=1, x_T=x),
        lambda m, c, x: m.dm_decoder.sample_dpm(cond=c, steps=1, order=1,
                                                x_T=x), slots, x_T)
    assert out["port16"].dtype == torch.float32
    check_all(out, (None,), {None: 1.0}, "LDMSlotFormer decode step")
