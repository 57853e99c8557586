"""The port's SLATE and STEVE against the JAX package, on the CPU, and
what the baselines train, serve and read.

- SLATE and STEVE of tiny configs (tests/torch_parity_helpers.py:
  tiny_baseline_config) on the same seeded weights: `encode`,
  `compute_losses` (STEVE with and without its pixel loss, the gumbel
  sample shared), every gradient outside the frozen dVAE, and
  `recon_img` (greedy AR generation, argmax, the dVAE's decode);
- the configs against their JAX files, `graft_pretrained` of a dVAE;
- the `encode` surface of STEVE and SLATE, and its refusal for SA and
  SAVi, whose testing forward carries no masks.

The modules are in tests/test_torch_baselines.py, training in
tests/test_torch_baseline_training.py. Both sides run slot
attention's f32 formula (`use_pallas="auto"`). f32 tolerances are
`rtol=1e-4, atol=1e-5` unless a test says otherwise.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.models import blocks as jblocks
from slotdiffusion_tpu_torch import configs, serving
from slotdiffusion_tpu_torch.convert import convert_model
from slotdiffusion_tpu_torch.models import build_model, init_reference_
from slotdiffusion_tpu_torch.training.checkpoint import (graft_pretrained,
                                                         save_checkpoint)
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, T_FRAMES, VOCAB,
                                  build_pair, images, t2n,
                                  tiny_baseline_config, tiny_image_config,
                                  video)

TOL = dict(rtol=1e-4, atol=1e-5)
B = 2
H4 = RES[0] // 4  # the token map's side


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: this file's ops are small, and beside other
    test processes more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def slate():
    return build_pair(cfg=tiny_baseline_config("SLATE"))


@pytest.fixture(scope="module")
def steve():
    return build_pair(cfg=tiny_baseline_config("STEVE", img_recon=True))


def _jit(jm, fn):
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=fn))


def _grads_close(model, jgrads, cfg, skip="dvae."):
    """Every gradient outside the frozen dVAE against `jax.grad` (rtol
    1e-4, atol 2e-5 of the leaf's scale or of a hundredth of the largest);
    each non-zero."""
    want = {k: v for k, v in convert_model(jax.tree_util.tree_map(
        np.asarray, jgrads), cfg).items() if not k.startswith(skip)}
    got = {n: p.grad for n, p in model.named_parameters()
           if not n.startswith(skip)}
    assert set(want) == set(got)
    floor = 1e-2 * max(w.abs().max().item() for w in want.values())
    for n, w in want.items():
        assert w.abs().max() > 0, n
        np.testing.assert_allclose(
            t2n(got[n]), t2n(w), rtol=1e-4,
            atol=2e-5 * max(w.abs().max().item(), floor), err_msg=n)


# ---- SLATE -----------------------------------------------------------------

def _slate_loss(m, img):
    return m.compute_losses({"img": img})[1]["token_recon_loss"]


def test_slate_encode_loss_and_every_gradient_match_jax(slate):
    """Slots and masks at the visual resolution (16x16: the plain CNN),
    the dVAE's target ids (equal), the teacher-forced logits, the token
    cross-entropy rtol 1e-5 and every gradient outside the frozen dVAE;
    `testing` returns slots and masks only."""
    cfg, jm, jv, tm = slate
    img = images(3)
    ref = _jit(jm, lambda m, x: m({"img": x}))(jv, img)
    want, jgrads = jax.jit(jax.value_and_grad(lambda p, x: jm.apply(
        {"params": p}, x, method=_slate_loss)))(jv["params"],
                                                jnp.asarray(img))
    model = tm.train()
    model.zero_grad(set_to_none=True)
    out, losses = model.compute_losses({"img": torch.from_numpy(img)})
    assert out["masks"].shape == (B, SLOTS, *RES)
    np.testing.assert_array_equal(t2n(out["target_token_id"]),
                                  np.asarray(ref["target_token_id"]))
    for k in ("slots", "masks", "pred_token_id"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
    losses["token_recon_loss"].backward()
    np.testing.assert_allclose(losses["token_recon_loss"].item(),
                               float(want), rtol=1e-5)
    _grads_close(model, jgrads, cfg)
    model.zero_grad(set_to_none=True)
    model.eval()
    with torch.no_grad():
        assert set(model({"img": torch.from_numpy(img)}, testing=True)) == \
            {"slots", "masks"}


def test_slate_recon_img_matches_jax(slate):
    """`recon_img`: the greedy generation of the 16 tokens, their one-hots
    decoded by the dVAE, against the JAX model's `recon_img`."""
    _, jm, jv, tm = slate
    slots = np.random.RandomState(4).randn(B, SLOTS, SLOT_SIZE).astype(
        np.float32)
    want = _jit(jm, lambda m, s: m.recon_img(s))(jv, slots)
    got = tm.recon_img(torch.from_numpy(slots))
    assert got.shape == (B, *RES, 3)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


# ---- STEVE -----------------------------------------------------------------

def _steve_losses(m, img, key):
    """The JAX STEVE's losses with the gumbel key of its pixel loss given
    (its `__call__` takes one from `make_rng`): the model's token path,
    then the same soft gumbel decode at tau 0.1 composed here."""
    out = m({"img": img})
    logp = jax.nn.log_softmax(out["pred_token_id"], axis=-1)
    ce = -jnp.take_along_axis(
        logp.reshape(-1, VOCAB), out["target_token_id"].reshape(-1, 1),
        axis=-1).mean()
    z = jblocks.gumbel_softmax(key, logp, tau=0.1).reshape(-1, H4, H4,
                                                           VOCAB)
    recon = m.dvae.detokenize(z)
    return ce + jnp.mean((recon - img.reshape(recon.shape)) ** 2), (ce,
                                                                   recon)


def test_steve_encode_losses_and_every_gradient_match_jax(steve):
    """Slots and masks at the visual resolution (4x4: the GN-ResNet), the
    token logits, the token cross-entropy and the pixel loss through a
    soft gumbel decode at tau 0.1 (the gumbel sample shared), each rtol
    1e-5, and every gradient of their sum outside the frozen dVAE."""
    cfg, jm, jv, tm = steve
    clip = video(6, B=B)
    key = jax.random.PRNGKey(9)
    (total, (ce, recon)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, x: jm.apply({"params": p}, x, key, method=_steve_losses,
                              rngs={"gumbel": key}), has_aux=True))(
        jv["params"], jnp.asarray(clip))
    e = np.array(jax.random.exponential(key, (B * T_FRAMES, H4 * H4,
                                              VOCAB)))
    model = tm.train()
    model.zero_grad(set_to_none=True)
    out, losses = model.compute_losses({"img": torch.from_numpy(clip)},
                                       exp_sample=torch.from_numpy(e))
    assert out["masks"].shape == (B, T_FRAMES, SLOTS, H4, H4)
    assert set(losses) == {"token_recon_loss", "img_recon_loss"}
    np.testing.assert_allclose(t2n(out["recon_img"]), np.asarray(recon),
                               **TOL)
    np.testing.assert_allclose(losses["token_recon_loss"].item(), float(ce),
                               rtol=1e-5)
    sum(losses.values()).backward()
    np.testing.assert_allclose(sum(v.item() for v in losses.values()),
                               float(total), rtol=1e-5)
    _grads_close(model, jgrads, cfg)
    model.zero_grad(set_to_none=True)
    model.eval()


def test_steve_without_pixel_loss_and_recon_img_match_jax():
    """STEVE as its configs run it (no pixel loss): the token loss of a
    clip, `prev_slots` (every frame through the predictor), and
    `recon_img` of [B, T, S, D] slots to [B, T, H, W, 3] frames."""
    cfg, jm, jv, tm = build_pair(cfg=tiny_baseline_config("STEVE"))
    clip = video(7, B=B)
    prev = np.random.RandomState(8).randn(B, SLOTS, SLOT_SIZE).astype(
        np.float32)
    _, want = _jit(jm, lambda m, x: m.compute_losses({"img": x}))(jv, clip)
    ref = _jit(jm, lambda m, x, p: m({"img": x}, prev_slots=p,
                                     testing=True))(jv, clip, prev)
    with torch.no_grad():
        _, got = tm.compute_losses({"img": torch.from_numpy(clip)})
        out = tm({"img": torch.from_numpy(clip)},
                 prev_slots=torch.from_numpy(prev), testing=True)
    assert set(got) == {"token_recon_loss"}
    np.testing.assert_allclose(got["token_recon_loss"].item(),
                               float(want["token_recon_loss"]), rtol=1e-5)
    for k in ("slots", "masks"):
        np.testing.assert_allclose(t2n(out[k]), np.asarray(ref[k]), **TOL)
    slots = np.asarray(ref["slots"])
    want = _jit(jm, lambda m, s: m.recon_img(s))(jv, slots)
    got = tm.recon_img(torch.from_numpy(slots))
    assert got.shape == (B, T_FRAMES, *RES, 3)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


# ---- configs ----------------------------------------------------------------

# the port's kernel knob, and the JAX keys no port module reads (the orbax
# dVAE path: the port's configs leave the stage-1 file to the run)
PORT_ONLY = {"use_pallas"}
JAX_ONLY = {"dvae_ckp_path"}


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return [_plain(x) for x in v] if isinstance(v, (list, tuple)) else v


def _same_config(mine, ref, where):
    for k in set(mine) | set(ref):
        if k not in ref:
            assert k in PORT_ONLY, f"{where}.{k}"
        elif k not in mine:
            assert k in JAX_ONLY, f"{where}.{k}"
        elif isinstance(ref[k], dict):
            _same_config(mine[k], ref[k], f"{where}.{k}")
        else:
            assert mine[k] == ref[k], (f"{where}.{k}", mine[k], ref[k])


@pytest.mark.parametrize("name,path", [
    ("SAViMoviE128", "video_based/savi/savi_movie_params-res128.py"),
    ("SAViMoviD128", "video_based/savi/savi_movid_params-res128.py"),
    ("SAViMoviSolid128", "video_based/savi/savi_movisolid_params-res128.py"),
    ("SAViMoviTex128", "video_based/savi/savi_movitex_params-res128.py"),
    ("STEVEMoviE128", "video_based/steve/steve_movie_params-res128.py"),
    ("STEVEMoviD128", "video_based/steve/steve_movid_params-res128.py"),
    ("STEVEMoviSolid128",
     "video_based/steve/steve_movisolid_params-res128.py"),
    ("STEVEMoviTex128", "video_based/steve/steve_movitex_params-res128.py"),
    ("DVAEMoviE128", "video_based/steve/dvae_movie_params-res128.py"),
    ("DVAEMoviD128", "video_based/steve/dvae_movid_params-res128.py"),
    ("DVAEMoviSolid128", "video_based/steve/dvae_movisolid_params-res128.py"),
    ("DVAEMoviTex128", "video_based/steve/dvae_movitex_params-res128.py"),
    ("SLATECLEVRTex128", "img_based/slate/slate_clevrtex_params-res128.py"),
    ("SLATECelebA128", "img_based/slate/slate_celeba_params-res128.py"),
    ("DVAECLEVRTex128", "img_based/slate/dvae_clevrtex_params-res128.py"),
    ("DVAECelebA128", "img_based/slate/dvae_celeba_params-res128.py"),
    ("SAViSynthetic64", "savi_synthetic_params-res64.py"),
    ("DVAESyntheticLong64", "dvae_synthetic_long-res64.py"),
    ("SLATESyntheticLong64", "slate_synthetic_long-res64.py"),
    ("STEVESyntheticLong64", "steve_synthetic_long-res64.py")])
def test_baseline_configs_match_the_jax_config_files(name, path):
    """Every setting the port's config shares with its JAX config file
    (training, data, the model's nested dicts) is equal, but the port's
    kernel knob and the JAX orbax dVAE path; the model builds from it."""
    from slotdiffusion_tpu.utils import load_params
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = load_params(os.path.join(repo, "configs", path))
    mine = configs.get_config(name)
    keys = [k for k in dir(mine) if not k.startswith("_") and
            not callable(getattr(mine, k)) and ref.has(k)]
    assert {"model", "lr", "train_batch_size", "dataset", "max_epochs",
            "resolution"} <= set(keys)
    _same_config({k: _plain(getattr(mine, k)) for k in keys},
                 {k: _plain(ref.get(k)) for k in keys}, name)
    if mine.resolution[0] <= 64:
        assert build_model(mine, device="cpu") is not None


# ---- graft_pretrained -------------------------------------------------------

def test_graft_pretrained_takes_a_dvae(tmp_path, slate):
    """A dVAE run's file (entries relative to the dVAE) and a SLATE
    checkpoint (prefixed `dvae.`) both graft into `model.dvae` bit for
    bit; a file that lacks an entry raises, and no path leaves the model
    as it is."""
    cfg, _, _, tm = slate
    dcfg = tiny_baseline_config("dVAE")
    src = build_model(dcfg, device="cpu")
    init_reference_(src, torch.Generator().manual_seed(3))
    run = str(tmp_path / "ckpt_last.pt")
    save_checkpoint(run, {"model": src.state_dict()})
    dst = copy.deepcopy(tm)
    assert not graft_pretrained(dst, cfg)
    gcfg = cfg.copy(dvae_dict=dict(cfg.dvae_dict, dvae_ckp_path=run))
    assert graft_pretrained(dst, gcfg)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.dvae.state_dict()[k], v), k
    whole = str(tmp_path / "slate.pt")
    save_checkpoint(whole, {"model": tm.state_dict()})
    assert graft_pretrained(dst, cfg.copy(dvae_dict=dict(
        cfg.dvae_dict, dvae_ckp_path=whole)))
    for k, v in tm.dvae.state_dict().items():
        assert torch.equal(dst.dvae.state_dict()[k], v), k
    sd = src.state_dict()
    sd.pop("decoder.11.bias")
    save_checkpoint(run, {"model": sd})
    with pytest.raises(KeyError):
        graft_pretrained(dst, gcfg)


# ---- serving ----------------------------------------------------------------

def test_steve_and_slate_serve_encode(slate, steve, tmp_path):
    """`encode` of STEVE (clips) and SLATE (images), eagerly on the CPU:
    the model's slots and masks, the masks at the visual resolution as
    the JAX forwards return them; SLATE's artifact reloaded gives the
    same bits."""
    for (cfg, _, _, model), x in ((steve, video(3, B=B)),
                                  (slate, images(3))):
        fn, ex = serving.build_serving_fn(model, "encode",
                                          serving.data_shape(cfg, B))
        assert tuple(ex[0].shape) == x.shape
        slots, masks = fn(torch.from_numpy(x))
        with torch.no_grad():
            ref = model({"img": torch.from_numpy(x)}, testing=True)
        assert torch.equal(slots, ref["slots"]) and \
            torch.equal(masks, ref["masks"])
    path = str(tmp_path / "slate_encode.pt2")
    serving.save_artifact(path, fn, ex)
    call, _ = serving.load_artifact(path)
    s2, m2 = call(torch.from_numpy(x))
    assert torch.equal(s2, slots) and torch.equal(m2, masks)


@pytest.mark.parametrize("batch", [2, 3])
@pytest.mark.parametrize("model_name", ["SA", "SAVi"])
def test_encode_surface_refuses_models_without_masks(model_name, batch):
    """SA and SAVi return slots only from their testing forward (the JAX
    `build_serving_fn` reads `out["masks"]` and fails on them): building
    their `encode` surface raises a ValueError naming the model, at any
    batch size; their forward still runs."""
    cfg = tiny_image_config("SA") if model_name == "SA" else \
        tiny_baseline_config("SAVi")
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match=f"{model_name} has no encode"):
        serving.build_serving_fn(model, "encode",
                                 serving.data_shape(cfg, batch))
    x = images(1, B=batch) if model_name == "SA" else video(1, B=batch)
    with torch.no_grad():
        out = model({"img": torch.from_numpy(x)}, testing=True)
    assert set(out) == {"slots"} and out["slots"].shape[0] == batch
