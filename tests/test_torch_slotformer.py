"""The video-prediction and VQA stage of the port against the JAX package,
on the CPU, module by module, on seeded weights and numpy inputs:

- the rollouter (`SlotRollouter`, pre- and post-norm, sine and learnable
  temporal PE, without, sine and learnable slots PE): rollouts within
  TOL (f32 on both sides, sums in another order);
- SlotFormer's losses: the loss-decay weights, `vid_len`, the eval
  losses per step, and the image loss through the spatial broadcast
  decoder; LDMSlotFormer's slot loss with its frozen LDM;
- the readout's logits, loss and accuracies for each aggregation;
- `interleaved_rollout` at frame offsets 1 and 3 and on a ragged video,
  with one rollout function written once in numpy and once in torch:
  equal;
- `masks_to_boxes`: equal;
- `graft_pretrained` of `dm_ckp_path`: the raw parameters of a trainer's
  file, not its EMA (the JAX `apply_pretrained`), after the VQ-VAE's
  graft; an exported EMA file refused;
- the loss-decay factor of `build_method` against the JAX `cosine_anneal`
  it schedules;
- the rollouter in bf16: each encoder layer (pre- and post-norm) and one
  rollout step under tests/test_torch_bf16.py's per-layer gate, with its
  control that must fail, and a 4-step rollout under the whole-model
  gate;
- the full-width Physion configs: their settings as the JAX configs',
  and the JAX models' parameter trees converting into the port's
  models strictly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.methods.inference import \
    interleaved_rollout as jax_interleaved
from slotdiffusion_tpu.models import blocks as jax_blocks
from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.models.readout import PhysionReadout as JaxReadout
from slotdiffusion_tpu.models.slotformer import SlotRollouter as JaxRollouter
from slotdiffusion_tpu.models.slotformer import \
    TransformerEncoderLayer as JaxLayer
from slotdiffusion_tpu.ops.metrics import masks_to_boxes as jax_boxes
from slotdiffusion_tpu.utils import BaseParams, load_params
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import (_layernorm, _linear, _mha,
                                             convert_model,
                                             convert_slot_rollouter)
from slotdiffusion_tpu_torch.data.loader import DataModule
from slotdiffusion_tpu_torch.data.synthetic_slots import \
    SyntheticSlotsDataset
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.methods.inference import interleaved_rollout
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.models.predictor import TransformerEncoderLayer
from slotdiffusion_tpu_torch.models.readout import PhysionReadout
from slotdiffusion_tpu_torch.models.slotformer import SlotRollouter
from slotdiffusion_tpu_torch.ops.metrics import masks_to_boxes
from slotdiffusion_tpu_torch.training.checkpoint import (graft_pretrained,
                                                         save_checkpoint)
from test_torch_bf16 import check, check_layer, xla
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, random_params,
                                  t2n, tiny_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides, the same formulas summed in another order
TOL = dict(rtol=1e-4, atol=1e-5)
BF16 = torch.bfloat16
HISTORY, ROLLOUT = 4, 3
TINY_ROLLOUT = dict(num_slots=SLOTS, slot_size=SLOT_SIZE,
                    history_len=HISTORY, t_pe="sin", slots_pe="",
                    d_model=32, num_layers=2, num_heads=2, ffn_dim=64,
                    norm_first=True)


def _slots(seed=0, B=2, T=HISTORY + ROLLOUT):
    return np.random.RandomState(seed).randn(
        B, T, SLOTS, SLOT_SIZE).astype(np.float32)


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def _rollouter_pair(seed=0, dtype=torch.float32, **kw):
    """(JAX SlotRollouter, its params, port rollouter) on seeded weights;
    a learnable PE gets random values (its init is zeros)."""
    kw = dict(TINY_ROLLOUT, **kw)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    jm = JaxRollouter(**kw, dtype=jdt)
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, 1),
                            jax.random.PRNGKey(0), jnp.asarray(_slots()[:,
                                                               :HISTORY]))
    params = dict(random_params(shapes["params"], seed))
    r = np.random.RandomState(seed + 7)
    for pe in ("enc_t_pe", "enc_slots_pe"):
        if pe in params:
            params[pe] = r.randn(*params[pe].shape).astype(np.float32)
    port = SlotRollouter(**kw, compute_dtype=dtype)
    port.load_state_dict(_tensors(convert_slot_rollouter(params)),
                         strict=True)
    return jm, params, port


@pytest.mark.parametrize("norm_first,t_pe,slots_pe", [
    (True, "sin", ""), (False, "sin", ""), (True, "learnable", ""),
    (True, "sin", "sin"), (False, "learnable", "learnable")])
def test_rollouter_matches_jax(norm_first, t_pe, slots_pe):
    """The rollout of ROLLOUT steps from HISTORY frames within TOL; a
    learnable PE is a parameter of the state_dict, a sine one is not."""
    jm, params, port = _rollouter_pair(norm_first=norm_first, t_pe=t_pe,
                                       slots_pe=slots_pe)
    past = _slots(1)[:, :HISTORY]
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, ROLLOUT))(
        params, jnp.asarray(past))
    with torch.no_grad():
        got = port(torch.from_numpy(past), ROLLOUT)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)
    learnable = {k for k in ("enc_t_pe", "enc_slots_pe")
                 if "learnable" in (t_pe if k == "enc_t_pe" else slots_pe)}
    assert {k for k in port.state_dict() if "pe" in k} == learnable


def test_sin_pos_enc_counts_down():
    from slotdiffusion_tpu.models.slotformer import sin_pos_enc as jax_pe
    from slotdiffusion_tpu_torch.models.slotformer import sin_pos_enc
    for L, D in ((15, 256), (4, 32)):
        np.testing.assert_array_equal(t2n(sin_pos_enc(L, D)),
                                      np.asarray(jax_pe(L, D)))
    # position seq_len-1 first: the last row is position 0 (sin 0, cos 1)
    last = t2n(sin_pos_enc(4, 8))[0, -1]
    np.testing.assert_array_equal(last, [0, 0, 0, 0, 1, 1, 1, 1])


def _slotformer_config(model="SlotFormer", img_recon=False):
    """A tiny SlotFormer (with the spatial broadcast decoder of 16x16 for
    `img_recon`) or LDMSlotFormer (the tiny flagship's LDM)."""
    cfg = configs.SlotFormerSynthetic().copy(
        model=model, resolution=RES,
        slot_dict=dict(num_slots=SLOTS, slot_size=SLOT_SIZE),
        rollout_dict=dict(TINY_ROLLOUT),
        loss_dict=dict(rollout_len=ROLLOUT, use_img_recon_loss=img_recon))
    if img_recon:
        cfg.dec_dict = dict(dec_channels=(SLOT_SIZE, 16, 16, 16),
                            dec_resolution=(4, 4), dec_ks=5, dec_norm="")
    if model == "LDMSlotFormer":
        cfg.dec_dict = tiny_config().dec_dict
    return cfg


def _jax_params(cfg):
    p = BaseParams()
    for k in ("model", "resolution", "slot_dict", "dec_dict",
              "rollout_dict", "loss_dict"):
        setattr(p, k, getattr(cfg, k))
    return p


def _slotformer_pair(cfg, seed=0):
    jm = build_jax_model(_jax_params(cfg))
    data = {"slots": jnp.asarray(_slots()),
            "img": jnp.zeros((2, HISTORY + ROLLOUT, *RES, 3))}
    shapes = jax.eval_shape(lambda r, d: jm.init(r, d), {
        "params": jax.random.PRNGKey(0),
        "diffusion": jax.random.PRNGKey(1)}, data)
    params = random_params(shapes["params"], seed)
    port = build_model(cfg, device="cpu")
    port.load_state_dict(convert_model(params, cfg), strict=True)
    return jm, {"params": params}, port


@pytest.fixture(scope="module")
def slotformer():
    return _slotformer_pair(_slotformer_config())


@pytest.mark.parametrize("decay,vid_len,train", [
    (None, None, True), (0.4, None, True), (0.7, (5, 7), True),
    (0.7, (5, 7), False), (1.0, None, False)])
def test_slotformer_losses_match_jax(slotformer, decay, vid_len, train):
    """The slot MSE with the loss-decay weights (normalised to sum to the
    rollout length), over `vid_len`'s steps with its N*C denominator, and
    at eval each step's plain MSE."""
    jm, jv, port = slotformer
    data = {"slots": _slots(2)}
    if vid_len is not None:
        data["vid_len"] = np.asarray(vid_len, np.int32)
    sched = None if decay is None else {"loss_decay_factor": decay}
    _, want = jax.jit(lambda v, d: jm.apply(
        v, d, sched, train, method=jm.compute_losses))(
        jv, {k: jnp.asarray(x) for k, x in data.items()})
    with torch.no_grad():
        _, got = port.compute_losses(
            {k: torch.from_numpy(x) for k, x in data.items()}, sched=sched,
            train=train)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_slotformer_image_loss_matches_jax():
    """With `use_img_recon_loss`: the rolled-out slots decoded by the
    frozen spatial broadcast decoder, its MSE against the future frames,
    with `vid_len`; the decoder's outputs carry no gradient, as the JAX
    model stops it."""
    cfg = _slotformer_config(img_recon=True)
    jm, jv, port = _slotformer_pair(cfg)
    r = np.random.RandomState(3)
    data = {"slots": _slots(3), "vid_len": np.asarray([6, 7], np.int32),
            "img": r.uniform(-1, 1, (2, HISTORY + ROLLOUT, *RES, 3)
                             ).astype(np.float32)}
    sched = {"loss_decay_factor": 0.5}
    out_j, want = jax.jit(lambda v, d: jm.apply(
        v, d, sched, True, method=jm.compute_losses))(
        jv, {k: jnp.asarray(x) for k, x in data.items()})
    out, got = port.compute_losses(
        {k: torch.from_numpy(x) for k, x in data.items()}, sched=sched)
    for k in ("slot_recon_loss", "img_recon_loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(t2n(out["recon_combined"]),
                               np.asarray(out_j["recon_combined"]), **TOL)
    assert not got["img_recon_loss"].requires_grad
    assert [m for m in port.frozen_modules] == [port.decoder]


def test_ldm_slotformer_loss_and_frozen_decoder():
    """LDMSlotFormer's loss is the slot MSE alone, as the JAX model's; the
    whole LDM is what the trainer freezes."""
    cfg = _slotformer_config("LDMSlotFormer")
    jm, jv, port = _slotformer_pair(cfg)
    data = {"slots": _slots(4)}
    _, want = jax.jit(lambda v, d: jm.apply(
        v, d, {"loss_decay_factor": 0.3}, False,
        method=jm.compute_losses))(jv, {"slots": jnp.asarray(data["slots"])})
    with torch.no_grad():
        _, got = port.compute_losses(
            {"slots": torch.from_numpy(data["slots"])},
            sched={"loss_decay_factor": 0.3}, train=False)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5)
    assert port.frozen_modules == (port.dm_decoder,)


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_readout_matches_jax(agg):
    """Logits over the slot pairs in combinations order, the stable BCE,
    and at eval the accuracy at each threshold of arange(0.1, 1, 0.2)."""
    rd = dict(num_slots=5, slot_size=16, agg_func=agg, feats_dim=24)
    jm = JaxReadout(readout_dict=rd)
    r = np.random.RandomState(5)
    data = {"slots": r.randn(8, 6, 5, 16).astype(np.float32),
            "label": r.randint(0, 2, (8,)).astype(np.int32)}
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    params = random_params(jax.eval_shape(
        lambda k, d: jm.init(k, d), jax.random.PRNGKey(0), jd)["params"])
    port = PhysionReadout(rd)
    port.load_state_dict(convert_model(params, configs.ReadoutSynthetic()),
                         strict=True)
    td = {k: torch.from_numpy(v) for k, v in data.items()}
    for train in (True, False):
        out_j, want = jm.apply({"params": params}, jd, train=train,
                               method=jm.compute_losses)
        with torch.no_grad():
            out, got = port.compute_losses(td, train=train)
        np.testing.assert_allclose(t2n(out["logits"]),
                                   np.asarray(out_j["logits"]), **TOL)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=1e-5, err_msg=k)
    assert sorted(want) == ["acc_0.10", "acc_0.30", "acc_0.50", "acc_0.70",
                            "acc_0.90", "vqa_loss"]


def _np_rollout(past, pred_len):
    """A rollout written in numpy: frame k is the mean of the past plus
    k + 1 and the past's first frame."""
    base = past.mean(1) + past[:, 0]
    return np.stack([base + k + 1 for k in range(pred_len)], 1)


def _torch_rollout(past, pred_len):
    base = past.mean(1) + past[:, 0]
    return torch.stack([base + k + 1 for k in range(pred_len)], 1)


@pytest.mark.parametrize("T,obs,history,offset", [
    (20, 8, 4, 1), (30, 15, 5, 3), (23, 10, 3, 3), (17, 9, 2, 4)])
def test_interleaved_rollout_matches_jax(T, obs, history, offset):
    """The observed frames kept, each offset's strided subsequence rolled
    out from its first `history` frames (ragged videos give the offsets
    different lengths) and interleaved: equal to the JAX function's."""
    slots = np.random.RandomState(T).randn(2, T, 3, 4).astype(np.float32)
    want = jax_interleaved(slots, _np_rollout, obs, history, offset)
    got = interleaved_rollout(torch.from_numpy(slots), _torch_rollout, obs,
                              history, offset)
    np.testing.assert_allclose(t2n(got), want, rtol=0, atol=1e-6)
    assert got.shape == slots.shape


def test_interleaved_rollout_asserts():
    s = torch.zeros(1, 10, 2, 2)
    with pytest.raises(AssertionError):
        interleaved_rollout(s, _torch_rollout, 10, 2, 1)
    with pytest.raises(AssertionError):
        interleaved_rollout(s, _torch_rollout, 5, 2, 3)


def test_masks_to_boxes_matches_jax():
    r = np.random.RandomState(0)
    masks = r.randint(0, 6, (2, 3, 9, 7))
    masks[0, 1] = 2  # one id fills a frame, the others are absent
    masks[1, 2, :, :] = 0
    masks[1, 2, 4, 5] = 6
    for n in (7, 4):
        np.testing.assert_array_equal(t2n(masks_to_boxes(
            torch.from_numpy(masks), n)), jax_boxes(masks, n))


def test_dm_graft_takes_the_raw_decoder_after_the_vqvae(tmp_path):
    """`dm_ckp_path` grafts a trainer file's raw `dm_decoder.*` (not its
    EMA shadow: the JAX `apply_pretrained` grafts `params`) after the
    `vqvae_ckp_path` graft, so the decoder file's VQ-VAE wins; an
    exported file with the EMA swapped in is refused."""
    cfg = _slotformer_config("LDMSlotFormer")
    src = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    raw = {k: torch.randn(v.shape, generator=gen)
           for k, v in src.state_dict().items()}
    shadow = {k: v + 1 for k, v in raw.items() if k.startswith("dm_decoder.")}
    vq_only = {k[len("dm_decoder.vae.vqvae."):]: v - 5 for k, v in
               raw.items() if k.startswith("dm_decoder.vae.vqvae.")}
    dm_file, vq_file = str(tmp_path / "savi.pt"), str(tmp_path / "vq.pt")
    save_checkpoint(dm_file, {"model": raw, "ema": {"shadow": shadow}})
    save_checkpoint(vq_file, {"model": vq_only})
    dec = dict(cfg.dec_dict, dm_ckp_path=dm_file)
    dec["vae_dict"] = dict(dec["vae_dict"], vqvae_ckp_path=vq_file)
    model = build_model(cfg, device="cpu")
    assert graft_pretrained(model, cfg.copy(dec_dict=dec))
    got = model.state_dict()
    for k, v in raw.items():
        if k.startswith("dm_decoder."):
            assert torch.equal(got[k], v), k
        else:
            assert not torch.equal(got[k], v), k
    save_checkpoint(dm_file, {"model": raw, "ema": True})
    with pytest.raises(ValueError, match="--no_ema"):
        graft_pretrained(model, cfg.copy(dec_dict=dict(
            cfg.dec_dict, dm_ckp_path=dm_file)))


@pytest.mark.parametrize("use_decay", [True, False])
def test_loss_decay_factor_matches_jax_schedule(use_decay):
    """`build_method` schedules `loss_decay_factor` as the JAX
    methods/build.py does: a cosine from `loss_decay_min` to 1 over
    `loss_decay_pct` of the run's steps, only under `use_loss_decay`; the
    trainer hands it to `compute_losses` as `sched`."""
    cfg = _slotformer_config().copy(use_loss_decay=use_decay,
                                    loss_decay_min=0.2, loss_decay_pct=0.4,
                                    max_epochs=3, train_batch_size=4,
                                    print_iter=1000)
    data = DataModule(SyntheticSlotsDataset(
        16, SLOTS, SLOT_SIZE, HISTORY + ROLLOUT), None, 4)
    trainer = build_method(build_model(cfg, device="cpu"), data, cfg)
    if not use_decay:
        assert trainer.sched_kwargs() == {}
        return
    total = 3 * len(data)
    for step in (0, 1, 2, 4, 5, 9):
        want = float(jax_blocks.cosine_anneal(jnp.int32(step), 0.2, 1.0, 0,
                                              0.4 * total))
        assert trainer.step_scalars["loss_decay_factor"](step) == want
        trainer.step = step
        assert trainer.sched_kwargs() == {"sched": {
            "loss_decay_factor": want}}


# ---- bf16 -----------------------------------------------------------------


@pytest.mark.parametrize("norm_first", [True, False])
def test_encoder_layer_rounds_as_jax_bf16(norm_first):
    """One rollouter layer in bf16 under the per-layer gate (d <= 0.1
    floor) with its control (the port in f32 must fail it)."""
    jax_mod = lambda d: JaxLayer(d_model=32, num_heads=2, ffn_dim=64,
                                 norm_first=norm_first, dtype=d)
    x = np.random.RandomState(6).randn(4, 12, 32).astype(np.float32)
    params = random_params(jax.eval_shape(
        jax_mod(jnp.float32).init, jax.random.PRNGKey(0),
        jnp.asarray(x))["params"])
    sd = {}
    _mha(sd, "self_attn", params["attn"])
    _layernorm(sd, "norm1", params["LayerNorm_0"])
    _layernorm(sd, "norm2", params["LayerNorm_1"])
    _linear(sd, "linear1", params["Dense_0"])
    _linear(sd, "linear2", params["Dense_1"])
    out = {}
    for dt, jdt in ((BF16, jnp.bfloat16), (torch.float32, jnp.float32)):
        tag = f"{dt.itemsize * 8}"
        jx = jnp.asarray(x).astype(jdt)
        out["jax" + tag] = xla(jax_mod(jdt).apply, {"params": params}, jx)
        port = TransformerEncoderLayer(32, 2, 64, norm_first, dt)
        port.load_state_dict(_tensors(sd), strict=True)
        with torch.no_grad():
            out["port" + tag] = port(torch.from_numpy(np.array(
                jx.astype(jnp.float32))).to(dt))
    assert out["port16"].dtype == BF16
    check_layer(f"encoder layer (norm_first={norm_first})", out["port16"],
                out["port32"], out["jax16"], out["jax32"])


@pytest.fixture(scope="module")
def bf16_rollouters():
    """The same seeded weights in JAX and port rollouters of each dtype
    (sine temporal PE, learnable slots PE)."""
    kw = dict(slots_pe="learnable")
    j16, params, p16 = _rollouter_pair(dtype=BF16, **kw)
    j32, _, p32 = _rollouter_pair(**kw)
    return dict(j16=j16, j32=j32, params=params, p16=p16, p32=p32)


def test_rollout_step_rounds_as_jax_bf16(bf16_rollouters):
    """One step (in_proj + PE, 2 layers, out_proj of the last N tokens)
    under the per-layer gate, with its control; the window stays f32 and
    the prediction comes out in bf16, as the JAX scan carries them."""
    m = bf16_rollouters
    past = _slots(8)[:, :HISTORY]
    out = {}
    for tag in ("16", "32"):
        out["jax" + tag] = xla(lambda p, x, jm=m["j" + tag]: jm.apply(
            {"params": p}, x, 1), m["params"], jnp.asarray(past))[:, 0]
        with torch.no_grad():
            out["port" + tag] = m["p" + tag](torch.from_numpy(past), 1)[:, 0]
    assert out["port16"].dtype == BF16 and out["jax16"].dtype == jnp.bfloat16
    check_layer("rollout step", out["port16"], out["port32"], out["jax16"],
                out["jax32"])


def test_rollout_matches_jax_bf16(bf16_rollouters):
    """4 steps, each feeding its bf16 prediction back into the f32 window:
    the whole-model gate (d <= 2 floor, 0.5 <= own / floor <= 2)."""
    m = bf16_rollouters
    past = _slots(9)[:, :HISTORY]
    out = {}
    for tag in ("16", "32"):
        out["jax" + tag] = xla(lambda p, x, jm=m["j" + tag]: jm.apply(
            {"params": p}, x, 4), m["params"], jnp.asarray(past))
        with torch.no_grad():
            out["port" + tag] = m["p" + tag](torch.from_numpy(past), 4)
    check("4-step rollout", out["port16"], out["port32"], out["jax16"],
          out["jax32"], bound=0.5)


# ---- the full-width Physion configs ----------------------------------------

PHYSION = {
    "SAViLDMPhysion128":
        "configs/video_based/savi_ldm/savi_ldm_physion_params-res128.py",
    "VQVAEPhysion128":
        "configs/video_based/savi_ldm/vqvae_physion_params-res128.py",
    "LDMSlotFormerPhysion128":
        "configs/vp_vqa/ldmslotformer_physion_params-res128.py",
    "ReadoutPhysion": "configs/vp_vqa/readout_physion_params.py",
}
# the training and data settings a port config copies from its JAX one
SETTINGS = ("model", "dataset", "max_epochs", "lr", "clip_grad",
            "warmup_steps_pct", "train_batch_size", "val_batch_size",
            "video_len", "frame_offset", "tasks", "resolution",
            "rollout_dict", "loss_dict", "readout_dict", "slot_dict",
            "vqa_loss_w", "slot_recon_loss_w", "input_frames")


@pytest.mark.parametrize("name", sorted(PHYSION))
def test_physion_config_mirrors_jax_and_loads_its_params(name):
    """The port's Physion config has the JAX config's settings (the
    slot dict but for the port's kernel knob), and the JAX model's
    parameter tree (shapes by jax.eval_shape, nothing compiled) converts
    into the port's model strictly, every name with its shape."""
    jp = load_params(os.path.join(REPO, PHYSION[name]))
    cfg = configs.get_config(name)
    for k in SETTINGS:
        if not (hasattr(jp, k) and hasattr(cfg, k)):
            # the JAX configs' viz (`input_frames`) and SAViDiffusion's
            # `loss_dict` (its one loss, always on) are not the port's
            assert k not in SETTINGS[:7], k
            continue
        want, got = getattr(jp, k), getattr(cfg, k)
        if k == "slot_dict":
            got = {a: b for a, b in got.items() if a != "use_pallas"}
        assert (tuple(got) if isinstance(got, (list, tuple)) else got) == \
            (tuple(want) if isinstance(want, (list, tuple)) else want), k
    if name == "VQVAEPhysion128":
        return  # test_torch_vqvae.py::test_every_config_builds holds it
    jm = build_jax_model(jp)
    T = getattr(jp, "n_sample_frames", 6)
    if name == "SAViLDMPhysion128":
        data = {"img": jnp.zeros((1, cfg.n_sample_frames, 128, 128, 3))}
    else:
        rd = getattr(jp, "readout_dict", None) or jp.rollout_dict
        data = {"slots": jnp.zeros((1, T, rd["num_slots"],
                                    rd["slot_size"])),
                "label": jnp.zeros((1,), jnp.int32)}
    shapes = jax.eval_shape(lambda r, d: jm.init(
        r, d, method=jm.compute_losses), {n: jax.random.PRNGKey(i)
                                          for i, n in enumerate((
                                              "params", "diffusion",
                                              "dropout"))}, data)["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    port = build_model(cfg, device="meta")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in convert_model(zeros, cfg).items()}
    assert got == want
