"""The port's token and reconstruction baselines against the JAX package,
on the CPU: the modules.

The same seeded weights (converted by `slotdiffusion_tpu_torch.convert`)
and numpy inputs go through the JAX module and its port: the gumbel
softmax on a shared Exp(1) sample, the cosine anneal, the pixel shuffle,
the dVAE's Conv2dBlock and the dVAE (tokens, decode, the tempered
forward, the loss and its gradients); every predictor over a 4-frame
clip with its carry, `sg_every` held by where its gradients stop; the
SAVi baseline (forward, `testing`, `prev_slots`, the loss and every
gradient); the AR token decoder (teacher forcing, block 0's post-LN,
greedy generation's ids and logits, sampled generation). SLATE, STEVE,
training, configs and serving are in tests/test_torch_token_models.py,
the repo's trained checkpoints in tests/test_torch_trained_baselines.py.

Both sides run slot attention's f32 formula (`use_pallas="auto"` where a
model holds it: the JAX model off the TPU computes that). f32
tolerances are `rtol=1e-4, atol=1e-5` unless a test says otherwise: the
same formulas summed in another order (measured errors are at most
~2e-6 on unit-scale outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.models import ar_decoder as jar
from slotdiffusion_tpu.models import blocks as jblocks
from slotdiffusion_tpu.models import dvae as jdvae
from slotdiffusion_tpu.models import predictor as jpred
from slotdiffusion_tpu_torch import convert
from slotdiffusion_tpu_torch.models import ar_decoder, blocks, dvae
from slotdiffusion_tpu_torch.models import predictor as tpred
from torch_parity_helpers import (SLOT_SIZE, SLOTS, T_FRAMES, VOCAB,
                                  build_pair, images, random_params, t2n,
                                  tiny_baseline_config, video)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: this file's ops are small, and beside other
    test processes more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(module, *args, seed=0):
    """Seeded numpy params of a flax `module` for `args` (shapes only)."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0),
                                                   *a), *args)
    return random_params(shapes["params"], seed)


def _grads_close(got, want, rel=1e-4, floor_frac=1e-2):
    """Each gradient within `rel` of its leaf's largest magnitude (or of a
    hundredth of the largest over all leaves, where that is larger)."""
    assert set(got) == set(want)
    floor = floor_frac * max(w.abs().max().item() for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(
            t2n(got[n]), t2n(w), rtol=rel,
            atol=2e-5 * max(w.abs().max().item(), floor), err_msg=n)


# ---- blocks ----------------------------------------------------------------

@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_jax_on_a_shared_sample(hard):
    """The same Exp(1) sample (JAX's `jax.random.exponential` draw of
    that key, as its gumbel_softmax makes it) through both: soft values
    rtol 1e-5; hard one-hots equal, with the soft sample's gradient
    (straight through) against `jax.grad`."""
    key = jax.random.PRNGKey(3)
    logits = np.random.RandomState(0).randn(4, 5, 7).astype(np.float32)
    e = np.array(jax.random.exponential(key, logits.shape, jnp.float32))
    proj = np.random.RandomState(1).randn(*logits.shape).astype(np.float32)
    f = lambda x: (jblocks.gumbel_softmax(key, x, 0.5, hard) * proj).sum()
    want = np.asarray(jblocks.gumbel_softmax(key, jnp.asarray(logits), 0.5,
                                             hard))
    gw = np.asarray(jax.grad(f)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = blocks.gumbel_softmax(x, 0.5, hard, exp_sample=torch.from_numpy(e))
    (got * torch.from_numpy(proj)).sum().backward()
    if hard:
        np.testing.assert_array_equal(t2n(got), want)
        assert set(np.unique(want)) == {0.0, 1.0}
    else:
        np.testing.assert_allclose(t2n(got), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t2n(x.grad), gw, rtol=1e-4, atol=1e-6)
    # a draw of its own needs a generator, and one generator gives one draw
    with pytest.raises(ValueError):
        blocks.gumbel_softmax(x, 0.5)
    a, b = (blocks.gumbel_softmax(x, 1.0, generator=torch.Generator()
                                  .manual_seed(5)) for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 7, 29, 30, 31, 100])
def test_cosine_anneal_matches_jax(step):
    """The dVAE's temperature: 1 -> 0.1 over 30 steps, both in f32 (the
    cosine of two libraries may differ in its last bit: rtol 1e-6)."""
    want = float(jblocks.cosine_anneal(jnp.int32(step), 1.0, 0.1, 0, 30))
    np.testing.assert_allclose(blocks.cosine_anneal(step, 1.0, 0.1, 0, 30),
                               want, rtol=1e-6)


def test_pixel_shuffle_is_torchs():
    """The JAX depth-to-space packs channels as torch's PixelShuffle: NCHW
    `F.pixel_shuffle` of the same values is the JAX NHWC result."""
    x = np.random.RandomState(2).randn(2, 3, 5, 16).astype(np.float32)
    want = np.asarray(jdvae.pixel_shuffle(jnp.asarray(x), 2))
    got = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(t2n(got), want)


@pytest.mark.parametrize("k,s", [(1, 1), (3, 1), (4, 4)])
def test_conv2d_block_matches_flax(k, s):
    """Bias-free conv (padding 0 at k = stride, else k // 2), one-group
    f32 GroupNorm, ReLU; the output shape and values."""
    x = np.random.RandomState(k).randn(2, 8, 8, 5).astype(np.float32)
    jm = jdvae.Conv2dBlock(6, k, s)
    params = _init(jm, jnp.asarray(x), seed=k)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = dvae.Conv2dBlock(5, 6, k, s)
    sd = {"m.weight": np.transpose(params["Conv_0"]["kernel"], (3, 2, 0, 1)),
          "weight": params["GroupNorm_0"]["scale"],
          "bias": params["GroupNorm_0"]["bias"]}
    port.load_state_dict({n: torch.from_numpy(np.array(v))
                          for n, v in sd.items()})
    with torch.no_grad():
        got = t2n(port(torch.from_numpy(x).permute(0, 3, 1, 2))
                  ).transpose(0, 2, 3, 1)
    assert got.shape == (2, 8 // s, 8 // s, 6)
    np.testing.assert_allclose(got, want, **TOL)


# ---- the dVAE --------------------------------------------------------------

@pytest.fixture(scope="module")
def dvae_pair():
    return build_pair(cfg=tiny_baseline_config("dVAE"))


def _jax_dvae_loss(m, img, key, tau, hard):
    """The JAX dVAE's training loss with the gumbel key given (its
    `__call__` takes it from `make_rng`): the same modules composed."""
    z_logits = jax.nn.log_softmax(m.encode_logits(img), axis=-1)
    z = jblocks.gumbel_softmax(key, z_logits, tau=tau, hard=hard)
    return jnp.mean((m.detokenize(z) - img) ** 2)


def test_dvae_tokens_and_decode_match_jax(dvae_pair):
    """Token logits, ids (equal), one-hots, the decode of random token
    probabilities, and the eval forward (the softmax at tau 0.3) with its
    loss; a video [B, T, H, W, 3] folds T into the batch."""
    _, jm, jv, tm = dvae_pair
    img = images()
    x = torch.from_numpy(img)
    ref = lambda fn, *a: np.asarray(jm.apply(jv, *map(jnp.asarray, a),
                                             method=fn))
    with torch.no_grad():
        np.testing.assert_allclose(t2n(tm.encode_logits(x)),
                                   ref(jm.encode_logits, img), **TOL)
        ids = t2n(tm.tokenize(x, one_hot=False))
        np.testing.assert_array_equal(
            ids, ref(lambda m, a: m.tokenize(a, one_hot=False), img))
        np.testing.assert_array_equal(t2n(tm.tokenize(x)),
                                      ref(jm.tokenize, img))
        assert ids.shape == (2, 4, 4)
        z = np.random.RandomState(1).dirichlet(
            np.ones(VOCAB), size=(2, 4, 4)).astype(np.float32)
        np.testing.assert_allclose(t2n(tm.detokenize(torch.from_numpy(z))),
                                   ref(jm.detokenize, z), **TOL)
        sched = {"gumbel_tau": 0.3}
        want_out, want = jm.apply(jv, {"img": jnp.asarray(img)}, sched,
                                  False, method=jm.compute_losses)
        out, got = tm.compute_losses({"img": x}, train=False, sched=sched)
        np.testing.assert_allclose(t2n(out["recon"]),
                                   np.asarray(want_out["recon"]), **TOL)
        np.testing.assert_allclose(got["recon_loss"].item(),
                                   float(want["recon_loss"]), rtol=1e-5)
        clip = video(B=1, T=2)
        np.testing.assert_array_equal(
            t2n(tm({"img": torch.from_numpy(clip)}, testing=True)
                ["token_id"]),
            ref(lambda m, a: m({"img": a}, testing=True)["token_id"],
                clip))


@pytest.mark.parametrize("hard", [False, True])
def test_dvae_gumbel_loss_and_gradients_match_jax(dvae_pair, hard):
    """The training forward at tau 0.5 with the gumbel sample shared:
    `recon_loss` rtol 1e-5 and every gradient against `jax.grad` (hard:
    the straight-through one-hot)."""
    cfg, jm, jv, tm = dvae_pair
    img = images(4)
    key = jax.random.PRNGKey(7)
    vg = jax.jit(jax.value_and_grad(lambda p, x: jm.apply(
        {"params": p}, x, key, 0.5, hard, method=_jax_dvae_loss)))
    want, jgrads = vg(jv["params"], jnp.asarray(img))
    e = np.array(jax.random.exponential(key, (2, 4, 4, VOCAB)))
    model = tm.train()
    model.zero_grad(set_to_none=True)
    _, losses = model.compute_losses(
        {"img": torch.from_numpy(img), "hard": hard},
        sched={"gumbel_tau": 0.5}, exp_sample=torch.from_numpy(e))
    losses["recon_loss"].backward()
    np.testing.assert_allclose(losses["recon_loss"].item(), float(want),
                               rtol=1e-5)
    want_g = convert.convert_model(jax.tree_util.tree_map(np.asarray, jgrads),
                                   cfg)
    _grads_close({n: p.grad for n, p in model.named_parameters()}, want_g)
    model.zero_grad(set_to_none=True)
    model.eval()


# ---- predictors ------------------------------------------------------------

PREDICTORS = {
    "transformer post-norm": dict(pred_type="transformer", pred_rnn=False,
                                  pred_norm_first=False, pred_num_layers=2,
                                  pred_num_heads=2, pred_ffn_dim=48),
    "mlp": dict(pred_type="mlp", pred_norm_first=True),
    "mlp post-norm": dict(pred_type="mlp", pred_norm_first=False),
    "rnn transformer": dict(pred_type="transformer", pred_rnn=True,
                            pred_num_layers=1, pred_num_heads=2,
                            pred_ffn_dim=48),
    "rnn mlp sg_every 2": dict(pred_type="mlp", pred_rnn=True,
                               pred_sg_every=2),
}
HIDDEN = 40  # the LSTM's width (SAVi passes `slot_mlp_size`)
CLIP = 4


def _predictor_pair(pred_dict, seed=0):
    jm = jpred.build_predictor(pred_dict, SLOT_SIZE, rnn_hidden_size=HIDDEN)
    x = jnp.zeros((2, SLOTS, SLOT_SIZE))
    params = _init(jm, x, seed=seed)
    port = tpred.build_predictor(pred_dict, SLOT_SIZE, HIDDEN)
    port.load_state_dict(convert._tensors(convert.convert_predictor(
        params, pred_dict)), strict=True)
    return jm, params, port


def _clip_inputs():
    r = np.random.RandomState(11)
    xs = r.randn(CLIP, 2, SLOTS, SLOT_SIZE).astype(np.float32)
    proj = r.randn(CLIP, 2, SLOTS, SLOT_SIZE).astype(np.float32)
    return xs, proj


def _run_port(port, xs, carry=None):
    outs = []
    for x in xs:
        if isinstance(port, tpred.RNNPredictorWrapper):
            o, carry = port(x, carry)
        else:
            o = port(x)
        outs.append(o)
    return torch.stack(outs), carry


def _run_jax(jm, params, xs):
    outs, carry = [], None
    for x in xs:
        o, carry = jm.apply({"params": params}, x, carry)
        outs.append(o)
    return jnp.stack(outs), carry


@pytest.mark.parametrize("name", sorted(PREDICTORS))
def test_predictors_match_jax_over_a_clip(name):
    """Each predictor over 4 frames, the carry threaded (the LSTM's (c, h)
    and step): every frame's output, the final carry, and the gradients
    of a projection of all outputs w.r.t. every frame's input and every
    parameter against `jax.grad`. With `sg_every = 2` the input and the
    state are detached at step 2: frame 2's input gets no gradient on
    either side, frames 0 and 1 only through their own outputs."""
    pred_dict = PREDICTORS[name]
    jm, params, port = _predictor_pair(pred_dict)
    xs, proj = _clip_inputs()

    def loss(p, xs):
        return (_run_jax(jm, p, xs)[0] * proj).sum()

    want, jcarry = _run_jax(jm, params, jnp.asarray(xs))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(xs))
    x = torch.from_numpy(xs).requires_grad_()
    got, carry = _run_port(port, x)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)
    (got * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(t2n(x.grad), np.asarray(gx), rtol=1e-4,
                               atol=1e-5 * np.abs(gx).max())
    want_g = convert._tensors(convert.convert_predictor(
        jax.tree_util.tree_map(np.asarray, gp), pred_dict))
    got_g = {n: p.grad for n, p in port.named_parameters()}
    if pred_dict.get("pred_rnn"):
        # flax's one LSTM bias is the sum of torch's two: both get its
        # gradient, the export puts it in bias_ih
        for n in [k for k in got_g if "bias_hh" in k]:
            got_g.pop(n)
            want_g.pop(n)
        assert carry["step"] == int(jcarry["step"]) == CLIP
        for (c, h), (jc, jh) in zip(carry["states"], jcarry["states"]):
            np.testing.assert_allclose(t2n(c), np.asarray(jc), **TOL)
            np.testing.assert_allclose(t2n(h), np.asarray(jh), **TOL)
    _grads_close(got_g, want_g)
    if pred_dict.get("pred_sg_every"):
        assert np.abs(np.asarray(gx)[2]).max() == 0
        assert x.grad[2].abs().max() == 0 and x.grad[3].abs().max() > 0


def test_build_predictor_dispatch():
    """None and "none" give no predictor, an unknown type raises, and the
    LSTM's width is the one given (SAVi's `slot_mlp_size`)."""
    assert tpred.build_predictor({"pred_type": None}, 8) is None
    assert tpred.build_predictor({"pred_type": "none"}, 8) is None
    with pytest.raises(ValueError):
        tpred.build_predictor({"pred_type": "gru"}, 8)
    p = tpred.build_predictor(dict(pred_type="mlp", pred_rnn=True), 8, 24)
    assert p.rnn.weight_hh_l0.shape == (4 * 24, 24)


# ---- SAVi --------------------------------------------------------------------

@pytest.fixture(scope="module")
def savi():
    return build_pair(cfg=tiny_baseline_config("SAVi"))


def test_savi_forward_testing_and_prev_slots_match_jax(savi):
    """The baseline's slots, image, per-slot RGB and masks of 2 clips of
    2 frames; `testing` returns the slots only; a continued chunk
    (`prev_slots`, every frame through the predictor) and the LSTM
    predictor's clip."""
    cfg, jm, jv, tm = savi
    clip = video(1, B=2)
    ref = jax.jit(lambda v, x: jm.apply(v, {"img": x}))(jv, clip)
    with torch.no_grad():
        out = tm({"img": torch.from_numpy(clip)})
        assert set(tm({"img": torch.from_numpy(clip)}, testing=True)) == \
            {"slots"}
    assert out["masks"].shape == (2, T_FRAMES, SLOTS, 16, 16, 1)
    for k in ("slots", "recon_img", "recons", "masks"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
    prev = np.random.RandomState(2).randn(2, SLOTS, SLOT_SIZE).astype(
        np.float32)
    ref = jax.jit(lambda v, x, p: jm.apply(v, {"img": x}, prev_slots=p,
                                           testing=True))(jv, clip, prev)
    with torch.no_grad():
        got = tm({"img": torch.from_numpy(clip)},
                 prev_slots=torch.from_numpy(prev), testing=True)
    np.testing.assert_allclose(t2n(got["slots"]), np.asarray(ref["slots"]),
                               **TOL)


def test_savi_with_the_lstm_predictor_matches_jax():
    """SAVi over 3 frames with the LSTM around the transformer (width
    `slot_mlp_size`): the carry threaded from frame to frame."""
    cfg = tiny_baseline_config("SAVi", pred_dict=PREDICTORS[
        "rnn transformer"])
    _, jm, jv, tm = build_pair(cfg=cfg)
    clip = video(4, B=1, T=3)
    ref = jax.jit(lambda v, x: jm.apply(v, {"img": x}, testing=True))(
        jv, clip)
    with torch.no_grad():
        got = tm({"img": torch.from_numpy(clip)}, testing=True)
    assert tm.predictor.hidden_size == cfg.slot_dict["slot_mlp_size"]
    np.testing.assert_allclose(t2n(got["slots"]), np.asarray(ref["slots"]),
                               **TOL)


def test_savi_loss_and_every_gradient_match_jax(savi):
    """The f32 `img_recon_loss` rtol 1e-5 and every gradient against
    `jax.grad` (as tests/test_torch_images.py's SA: rtol 1e-4, atol 2e-5
    of the leaf's scale or of a hundredth of the largest)."""
    cfg, jm, jv, tm = savi
    clip = video(5, B=2)

    def loss(p, x):
        return jm.apply({"params": p}, {"img": x},
                        method=jm.compute_losses)[1]["img_recon_loss"]

    want, jgrads = jax.jit(jax.value_and_grad(loss))(jv["params"],
                                                     jnp.asarray(clip))
    model = tm.train()
    model.zero_grad(set_to_none=True)
    _, losses = model.compute_losses({"img": torch.from_numpy(clip)})
    losses["img_recon_loss"].backward()
    np.testing.assert_allclose(losses["img_recon_loss"].item(), float(want),
                               rtol=1e-5)
    want_g = convert.convert_model(jax.tree_util.tree_map(np.asarray, jgrads),
                                   cfg)
    for n, w in want_g.items():
        assert w.abs().max() > 0, n
    _grads_close({n: p.grad for n, p in model.named_parameters()}, want_g)
    model.zero_grad(set_to_none=True)
    model.eval()


# ---- the AR token decoder ---------------------------------------------------

PATCHES = 16  # a 4x4 token map


@pytest.fixture(scope="module")
def ar_pair():
    jm = jar.STEVETransformerDecoder(vocab_size=VOCAB, d_model=SLOT_SIZE,
                                     n_head=2, max_len=PATCHES - 1,
                                     num_slots=SLOTS, num_layers=2)
    slots = jnp.zeros((2, SLOTS, SLOT_SIZE))
    idx = jnp.zeros((2, PATCHES - 1), jnp.int32)
    params = _init(jm, slots, idx, seed=3)
    port = ar_decoder.ARTransformerDecoder(VOCAB, SLOT_SIZE, 2,
                                           PATCHES - 1, SLOTS, 2)
    port.load_state_dict(convert._tensors(convert.convert_ar_decoder(
        params)), strict=True)
    return jm, {"params": params}, port.eval()


def _slots_and_ids(seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(2, SLOTS, SLOT_SIZE).astype(np.float32),
            r.randint(0, VOCAB, (2, PATCHES - 1)).astype(np.int64))


def test_ar_decoder_teacher_forcing_matches_jax(ar_pair):
    """Logits [B, 16, vocab] of BOS + 15 tokens: rtol 1e-4. Block 0 keeps
    its normed input as the residual stream (post-LN): the port's block 0
    made pre-LN moves the logits, so the check sees the quirk."""
    jm, jv, port = ar_pair
    slots, ids = _slots_and_ids()
    want = np.asarray(jm.apply(jv, jnp.asarray(slots),
                               jnp.asarray(ids.astype(np.int32))))
    with torch.no_grad():
        got = t2n(port(torch.from_numpy(slots), torch.from_numpy(ids)))
        assert got.shape == (2, PATCHES, VOCAB) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)
        port.tf_dec.blocks[0].is_first = False
        moved = t2n(port(torch.from_numpy(slots), torch.from_numpy(ids)))
        port.tf_dec.blocks[0].is_first = True
    assert np.abs(moved - want).max() > 1e-2


def test_ar_generate_greedy_matches_jax_and_the_forward(ar_pair):
    """Greedy KV-cached generation of 16 tokens: the ids equal the JAX
    scan's, the logits rtol 1e-4 of its, and of the port's own teacher-
    forced forward on the generated prefix (the cache computes what the
    full forward does)."""
    jm, jv, port = ar_pair
    slots, _ = _slots_and_ids(1)
    ids, logits = jax.jit(lambda v, s: jm.apply(
        v, s, PATCHES, method=jm.generate))(jv, jnp.asarray(slots))
    with torch.no_grad():
        got_ids, got = port.generate(torch.from_numpy(slots), PATCHES)
        forward = port(torch.from_numpy(slots), got_ids[:, :-1])
    np.testing.assert_array_equal(t2n(got_ids), np.asarray(ids))
    np.testing.assert_allclose(t2n(got), np.asarray(logits), **TOL)
    np.testing.assert_allclose(t2n(got), t2n(forward), **TOL)
    assert (t2n(got_ids) == t2n(got).argmax(-1)).all()


def test_ar_generate_sampled_is_seeded(ar_pair):
    """Sampled generation at temperature 2: ids in range, the logits of
    its prefix the forward's, one generator state one sequence, another
    state another; without a generator it raises."""
    _, _, port = ar_pair
    slots = torch.from_numpy(_slots_and_ids(2)[0])
    run = lambda seed: port.generate(
        slots, PATCHES, sample=True, temperature=2.0,
        generator=torch.Generator().manual_seed(seed))
    (a, la), (b, _), (c, _) = run(0), run(0), run(1)
    assert a.shape == (2, PATCHES) and la.shape == (2, PATCHES, VOCAB)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < VOCAB
    with torch.no_grad():
        np.testing.assert_allclose(t2n(la), t2n(port(slots, a[:, :-1])),
                                   **TOL)
    with pytest.raises(ValueError):
        port.generate(slots, PATCHES, sample=True)
