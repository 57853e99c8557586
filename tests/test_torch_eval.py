"""The pieces of the port's evaluation path against the JAX package, on
the CPU: the plain-CNN encoder (ConvNormAct with flax's "SAME" padding,
SAEncoder and its conversion walk), the segmentation and reconstruction
metrics, the MOVi data layer on a generated tree (batches, the retry on
a bad sample, the native decode), the trainer's validation schedule, and
slot attention's launch plan at the trained 64x64 model's shape."""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from slotdiffusion_tpu.data.loader import DataLoader as JaxLoader
from slotdiffusion_tpu.data.loader import _fetch_with_retry
from slotdiffusion_tpu.data.movi import build_movi_dataset
from slotdiffusion_tpu.methods.build import seg_metrics_fn as jax_seg_metrics
from slotdiffusion_tpu.models import blocks as jblocks
from slotdiffusion_tpu.models.sa import SAEncoder as JaxSAEncoder
from slotdiffusion_tpu.ops import metrics as JM
from slotdiffusion_tpu.utils import BaseParams
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import convert_sa_encoder
from slotdiffusion_tpu_torch.data import build_dataset
from slotdiffusion_tpu_torch.data import fastio
from slotdiffusion_tpu_torch.data.loader import (DataModule, SampleError,
                                                 epoch_batches,
                                                 fetch_with_retry,
                                                 make_loader)
from slotdiffusion_tpu_torch.data.transforms import BaseTransforms
from slotdiffusion_tpu_torch.methods.build import seg_metrics_fn
from slotdiffusion_tpu_torch.models.blocks import ConvNormAct
from slotdiffusion_tpu_torch.models.sa import SAEncoder
from slotdiffusion_tpu_torch.ops import metrics as M
from slotdiffusion_tpu_torch.ops import slot_attention_kernel as sak
from torch_parity_helpers import t2n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from gen_movi_tree import write_split  # noqa: E402

# both sides compute the metrics in float64 from the same integer counts
METRIC_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread for this file: its many small ops gain nothing
    from more, and beside other test processes more threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_state(flax_params, prefix=""):
    """flax ConvNormAct params -> the port ConvNormAct's state_dict."""
    p = flax_params
    sd = {"0.weight": np.transpose(np.asarray(p["Conv_0"]["kernel"]),
                                   (3, 2, 0, 1)),
          "0.bias": np.asarray(p["Conv_0"]["bias"])}
    norm = p.get("GroupNorm32_0", {}).get("GroupNorm_0") or \
        p.get("LayerNorm_0")
    if norm is not None:
        sd["1.weight"] = np.asarray(norm["scale"])
        sd["1.bias"] = np.asarray(norm["bias"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _randomize(tree, seed):
    """Seeded values for every leaf, so norm scales and biases are not
    their ones and zeros."""
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray((r.randn(*a.shape) * (
            0.3 if a.ndim == 1 else 1.0 / np.sqrt(np.prod(a.shape[:-1])))
            + (1.0 if a.ndim == 1 else 0.0)).astype(np.float32)), tree)


@pytest.mark.parametrize("norm", ["", "gn", "ln"])
@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_norm_act_matches_flax(stride, k, size, norm):
    """ConvNormAct with flax's "SAME" padding at stride 1 and 2, odd and
    even inputs: f32 on both sides, rtol 1e-5, and atol 1e-5 of the
    output's largest magnitude (a norm subtracts the mean, so a value near
    0 carries the f32 rounding of values ~3: measured 1.6e-6)."""
    x = np.random.RandomState(size * 10 + k).randn(2, size, size, 4
                                                   ).astype(np.float32)
    jm = jblocks.ConvNormAct(out_channels=8, kernel_size=k, stride=stride,
                             norm=norm, act="relu")
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))[
        "params"], seed=k + stride)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = ConvNormAct(4, 8, kernel_size=k, stride=stride, norm=norm,
                     act="relu")
    tm.load_state_dict(_torch_state(params), strict=True)
    out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(t2n(out), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_symmetric_padding_is_not_flax_same():
    """The trap the explicit padding avoids: at stride 2, k = 5, on an
    even input flax pads 1 before and 2 after; torch's symmetric
    `padding=2` gives another result."""
    x = np.random.RandomState(0).randn(1, 8, 8, 4).astype(np.float32)
    jm = jblocks.ConvNormAct(out_channels=8, kernel_size=5, stride=2,
                             act="")
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))[
        "params"], seed=1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    sd = _torch_state(params)
    sym = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), sd["0.weight"],
        sd["0.bias"], stride=2, padding=2).permute(0, 2, 3, 1)
    assert sym.shape == ref.shape
    assert np.abs(t2n(sym) - ref).max() > 1e-2


@pytest.mark.parametrize("res,norm", [(64, ""), (128, ""), (64, "gn"),
                                      (128, "ln")])
def test_plain_cnn_encoder_and_its_walk_match_jax(res, norm):
    """The plain-CNN SAEncoder (stride 2 at the first layer above 64
    pixels) with its parameters carried by `convert_sa_encoder`: rtol
    1e-4, atol 1e-5 (f32 through three 5x5 convs, LN and the MLP)."""
    enc = dict(enc_channels=(3, 8, 8, 8), enc_ks=5, enc_out_channels=16,
               enc_norm=norm)
    img = np.random.RandomState(res).uniform(-1, 1, (2, res, res, 3)
                                             ).astype(np.float32)
    jm = JaxSAEncoder(resolution=(res, res), enc_dict=enc,
                      enc_out_channels=16)
    params = _randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(img))[
        "params"], seed=res)
    ref, ref_res = jm.apply({"params": params}, jnp.asarray(img))
    tm = SAEncoder(enc, (res, res))
    sd = convert_sa_encoder(jax.tree_util.tree_map(np.asarray, params), enc)
    tm.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                        for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out, vis_res = tm(torch.from_numpy(img))
    assert vis_res == tuple(ref_res) == ((res // 2,) * 2 if res > 64
                                         else (res, res))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


# ---- metrics --------------------------------------------------------------

def _masks(seed, shape, ids):
    return np.random.RandomState(seed).randint(0, ids, shape)


def _both(fn_name, gt, pred):
    mine = getattr(M, fn_name)(torch.from_numpy(gt), torch.from_numpy(pred))
    ref = getattr(JM, fn_name)(gt, pred)
    return mine, ref


MASK_CASES = {
    "random": (_masks(0, (3, 16, 12), 5), _masks(1, (3, 16, 12), 4)),
    "video": (_masks(2, (2, 3, 8, 8), 4), _masks(3, (2, 3, 8, 8), 6)),
    "all_background": (np.zeros((2, 8, 8), np.int64),
                       _masks(4, (2, 8, 8), 3)),
    "single_segment_pred": (_masks(5, (2, 8, 8), 3),
                            np.zeros((2, 8, 8), np.int64)),
    "both_trivial": (np.zeros((2, 8, 8), np.int64),
                     np.ones((2, 8, 8), np.int64)),
    "one_background_image": (np.stack([np.zeros((8, 8), np.int64),
                                       _masks(6, (8, 8), 3)]),
                             _masks(7, (2, 8, 8), 3)),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
@pytest.mark.parametrize("metric", ["ARI_metric", "fARI_metric",
                                    "miou_metric", "fmiou_metric",
                                    "mbo_metric"])
def test_mask_metrics_match_jax(metric, case):
    """Every mask metric on seeded integer masks, the degenerate cases
    (all background, one segment, both trivial: ARI 1.0, FG metrics NaN)
    included: equal to 1e-9 (float64 on both sides), NaN where JAX's is."""
    gt, pred = MASK_CASES[case]
    mine, ref = _both(metric, gt, pred)
    if np.isnan(ref):
        assert np.isnan(mine)
    else:
        assert abs(mine - ref) <= METRIC_TOL, (mine, ref)


@pytest.mark.parametrize("video", [False, True])
def test_seg_metrics_fn_matches_jax(video):
    """seg_metrics_fn on seeded soft masks (argmax over the slots, T
    folded into H for a video): the five metrics under the JAX names, to
    1e-9."""
    r = np.random.RandomState(8 + video)
    shape = (2, 3, 5, 16, 16) if video else (2, 5, 16, 16)
    pred = r.rand(*shape).astype(np.float32)
    gt = r.randint(0, 4, shape[:-3] + shape[-2:])
    ref = jax_seg_metrics({"masks": gt}, {"masks": pred})
    mine = seg_metrics_fn({"masks": torch.from_numpy(gt)},
                          {"masks": torch.from_numpy(pred)})
    assert set(mine) == set(ref) == {"ari", "fari", "miou", "fmiou", "mbo"}
    for k in ref:
        assert abs(mine[k] - ref[k]) <= METRIC_TOL, (k, mine[k], ref[k])


def test_postproc_mask_matches_jax():
    """The background-aware argmax: equal ids."""
    m = np.random.RandomState(10).rand(2, 2, 4, 8, 8).astype(np.float32)
    m[0, 0] *= 0.4  # a frame where no slot reaches the threshold
    np.testing.assert_array_equal(t2n(M.postproc_mask(torch.from_numpy(m))),
                                  JM.postproc_mask(m))


def test_recon_metrics_match_jax():
    """MSE, PSNR and SSIM on seeded [0, 1] images: to 1e-9."""
    r = np.random.RandomState(11)
    x = r.rand(3, 24, 20, 3)
    y = np.clip(x + 0.1 * r.randn(*x.shape), 0, 1)
    for name in ("mse_metric", "psnr_metric", "ssim_metric"):
        mine = getattr(M, name)(torch.from_numpy(x).float(),
                                torch.from_numpy(y).float())
        ref = getattr(JM, name)(x.astype(np.float32), y.astype(np.float32))
        assert abs(mine - ref) <= METRIC_TOL * max(1.0, abs(ref)), name


# ---- the MOVi data layer ------------------------------------------------

@pytest.fixture(scope="module")
def movi_tree(tmp_path_factory):
    """3 train and 2 val videos of 6 frames at 64x64, written by
    scripts/gen_movi_tree.py's `write_split`; the split caches in the
    same temporary directory."""
    root = tmp_path_factory.mktemp("movi")
    write_split(str(root), "E", "train", 3, 6, 64, 0)
    write_split(str(root), "E", "validation", 2, 6, 64, 1)
    old = os.environ.get("SLOTDIFFUSION_CACHE")
    os.environ["SLOTDIFFUSION_CACHE"] = str(root / "cache")
    yield str(root)
    if old is None:
        del os.environ["SLOTDIFFUSION_CACHE"]
    else:
        os.environ["SLOTDIFFUSION_CACHE"] = old


def _cfgs(root):
    cfg = configs.SAViLDMMoviFile64().copy(data_root=root, num_workers=0)
    p = BaseParams()
    for k in ("dataset", "movi_level", "data_root", "resolution",
              "n_sample_frames", "frame_offset", "video_len", "load_mask"):
        setattr(p, k, getattr(cfg, k))
    return cfg, p


def _assert_same_batches(jax_loader, torch_loader):
    n = 0
    for a, b in zip(jax_loader, torch_loader, strict=True):
        assert set(a) == set(b)
        for k in a:
            bk = b[k].numpy()
            assert a[k].dtype == bk.dtype and np.array_equal(a[k], bk), k
        n += 1
    return n


def test_movi_batches_are_the_jax_loaders(movi_tree):
    """build_dataset("movi"): the train split (no masks) and the val split
    (masks) give the JAX loader's batches bit for bit, in order, for
    shuffle=False and for the epoch permutations of shuffle=True."""
    cfg, p = _cfgs(movi_tree)
    jtrain, jval = build_movi_dataset(p)
    train, val = build_dataset(cfg)
    assert (len(train), len(val)) == (len(jtrain), len(jval)) == (15, 6)
    assert "masks" not in train[0] and "masks" in val[0]
    for js, ts, bs in ((jtrain, train, 4), (jval, val, 4)):
        n = _assert_same_batches(
            JaxLoader(js, batch_size=bs, shuffle=False, drop_last=False,
                      num_workers=1),
            make_loader(ts, epoch_batches(len(ts), bs, drop_last=False)))
        assert n == -(-len(ts) // bs)
    dm = DataModule(train, val, 4, seed=3)
    for epoch in (0, 1):
        jl = JaxLoader(jtrain, batch_size=4, shuffle=True, drop_last=True,
                       num_workers=1, seed=3)
        jl.set_epoch(epoch)
        assert _assert_same_batches(jl, dm.train_loader(epoch)) == 3


def test_movi_full_videos_and_test_split(movi_tree):
    """`load_video`: whole videos with their masks and `data_idx` (the
    JAX get_video's); the test split is missing in this tree."""
    cfg, p = _cfgs(movi_tree)
    jval, val = build_movi_dataset(p)[1], build_dataset(cfg)[1]
    jval.load_video = val.load_video = True
    assert len(val) == len(jval) == 2
    a, b = jval[1], val[1]
    for k in ("img", "masks", "data_idx"):
        np.testing.assert_array_equal(a[k], b[k])
    assert b["img"].shape == (6, 64, 64, 3)
    with pytest.raises(FileNotFoundError):
        build_dataset(cfg, val_only=True)


def test_sample_error_retries_another_index(movi_tree, tmp_path):
    """A clip with a missing frame raises SampleError; the loader loads
    the index the JAX loader's retry draws instead."""
    from slotdiffusion_tpu.data.loader import SampleError as JaxSampleError

    class Flaky:
        def __init__(self, error):
            self.error = error

        def __len__(self):
            return 10

        def __getitem__(self, idx):
            if idx < 3:
                raise self.error(f"bad {idx}")
            return {"x": np.int32(idx)}

    for idx in range(4):
        got = fetch_with_retry(Flaky(SampleError), idx, seed=5)
        assert got == _fetch_with_retry(Flaky(JaxSampleError), idx, 5, 3)
        assert got["x"] >= 3
    # a frame removed from a copy of the tree: the same replacement clip
    root = str(tmp_path / "movi")
    shutil.copytree(movi_tree, root)
    os.remove(os.path.join(root, "MOVi-E", "validation", "00000",
                           "000001.jpg"))
    cfg, p = _cfgs(root)
    val, jval = build_dataset(cfg)[1], build_movi_dataset(p)[1]
    with pytest.raises(SampleError):
        val[0]
    _assert_same_batches(
        JaxLoader(jval, batch_size=3, shuffle=False, drop_last=False,
                  num_workers=1),
        make_loader(val, epoch_batches(len(val), 3, drop_last=False)))


def test_fastio_decode_equals_pil(tmp_path):
    """The port's native decode: a grayscale mask PNG equals PIL's nearest
    resize exactly, an RGB PNG is refused (None), and a JPEG is within the
    JAX package's bound of PIL's bilinear path (mean |diff| < 0.01) and
    equal to the JAX package's native decode."""
    if not fastio.fastio_available():
        pytest.skip("the native decode does not build here")
    from slotdiffusion_tpu.data.fastio import decode_jpeg_norm as jax_jpeg
    r = np.random.RandomState(1)
    ids = r.randint(0, 11, (64, 48)).astype(np.uint8)
    p = str(tmp_path / "m.png")
    Image.fromarray(ids, mode="L").save(p)
    tr = BaseTransforms((32, 24))
    np.testing.assert_array_equal(tr.load_mask(p), tr.process_mask(ids))
    rgb = str(tmp_path / "rgb.png")
    Image.fromarray(np.stack([ids, ids * 3, ids * 7], -1)).save(rgb)
    assert fastio.decode_png_mask(rgb, (32, 24)) is None
    img = (np.kron(r.rand(8, 10, 3), np.ones((32, 32, 1))) * 255).astype(
        np.uint8)
    j = str(tmp_path / "t.jpg")
    Image.fromarray(img).save(j, quality=95)
    out = fastio.decode_jpeg_norm(j, (128, 128))
    ref = BaseTransforms((128, 128))(Image.open(j).convert("RGB"))
    assert np.abs(out - ref).mean() < 0.01
    theirs = jax_jpeg(j, (128, 128))
    if theirs is not None:
        np.testing.assert_array_equal(out, theirs)


# ---- validation in the trainer --------------------------------------------

def test_synthetic_video_sets_are_the_jax_builders():
    """build_dataset("synthetic_video") gives the JAX builder's clips
    (train seed 0, val seed 1, 256 / 32 of them) bit for bit, and
    SyntheticVideoData builds the same splits."""
    from slotdiffusion_tpu.data import build_dataset as jax_build_dataset
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    cfg = configs.tiny_config().copy(dataset="synthetic_video",
                                     n_sample_frames=2)
    p = BaseParams(dataset="synthetic_video", resolution=cfg.resolution,
                   n_sample_frames=2)
    train, val = build_dataset(cfg)
    jtrain, jval = jax_build_dataset(p)
    assert (len(train), len(val)) == (len(jtrain), len(jval)) == (256, 32)
    assert len(build_dataset(cfg, val_only=True)) == 32
    data = SyntheticVideoData(cfg, 2, num_samples=256, val_samples=32)
    for ours, jax_set, module_set in ((train, jtrain, data.train_set),
                                      (val, jval, data.val_set)):
        for i in (0, 5):
            a, b, c = ours[i], jax_set[i], module_set[i]
            assert set(a) == set(b) == set(c)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a[k], c[k])


def test_fit_validates_every_eval_interval_and_at_the_end():
    """A tiny model, 1 step an epoch, 3 epochs, eval_interval 2: one
    validation after epoch 2 and one at the end; two calls of validate at
    one step give the same numbers (fresh draws per batch, seeded)."""
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    cfg = configs.tiny_config().copy(eval_interval=2, max_epochs=3,
                                     n_sample_frames=2)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    data = SyntheticVideoData(cfg, 2, num_samples=2, val_samples=3)
    trainer = build_method(model, data, cfg)
    records = []
    trainer.logger.log = lambda rec, step: records.append((step, rec))
    trainer.fit()
    val_steps = [s for s, r in records if "val/ari" in r]
    assert val_steps == [2, 3]
    again = trainer.validate()
    assert again == [r for s, r in records if "val/ari" in r][-1]
    assert set(again) == {"val/denoise_loss", "val/ari", "val/fari",
                          "val/miou", "val/fmiou", "val/mbo"}


def test_load_model_weights_swaps_in_a_trainers_ema(tmp_path):
    """A trainer's ckpt_last.pt loads strictly for evaluation with its EMA
    shadow in `dm_decoder`, as the JAX package's `load_model_params`
    swaps it in; the other tensors are the live ones."""
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.training.checkpoint import \
        load_model_weights
    cfg = configs.tiny_config().copy(use_ema=True, n_sample_frames=2)
    model = build_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    trainer = build_method(model, SyntheticVideoData(cfg, 2, num_samples=2),
                           cfg, ckp_path=str(tmp_path))
    trainer.fit(max_steps=2)
    fresh = build_model(cfg, device="cpu")
    load_model_weights(fresh, str(tmp_path / "ckpt_last.pt"))
    shadow = trainer.ema.shadow
    for name, p in fresh.named_parameters():
        want = shadow[name] if name in shadow else \
            dict(model.named_parameters())[name]
        assert torch.equal(p, want), name
    assert any(not torch.equal(shadow[n], p) for n, p in
               model.named_parameters() if n in shadow)


# ---- slot attention's plan at the trained 64x64 model's shape -------------

@pytest.mark.parametrize("B", [1, 8, 32])
def test_launch_plan_at_the_res64_shape(B):
    """N = 4096, S = 6, D = 64, M = 128: every position owned by exactly
    one block of the cluster, shared memory within the card's 232,448
    bytes a block, and the tile whole for resident k/v."""
    N, S, D, M = 4096, 6, 64, 128
    plan = sak.launch_plan(B, N, S, D, M)
    c, pos = plan["cluster"], plan["positions"]
    owned = np.zeros(N, np.int64)
    for r in range(c):
        owned[r * pos:min((r + 1) * pos, N)] += 1
    assert (owned == 1).all() and (c - 1) * pos < N
    assert plan["smem_bytes"] <= sak.SMEM_LIMIT == 232448
    assert plan["smem_bytes"] == sak.smem_bytes(D, M, c, plan["tile"],
                                                plan["resident"])
    assert B <= sak.ACTIVE_CLUSTERS[c] or c == 1
    if plan["resident"]:
        assert plan["tile"] >= pos
