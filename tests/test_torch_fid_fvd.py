"""The port's FID, FVD and LPIPS plumbing (`slotdiffusion_tpu_torch/ops/
fid.py`, `fvd.py`, `lpips.py`, `_provenance.py`) against the JAX
package's on the CPU.

Seeded torchvision-layout state dicts (the port's `random_inception_
state_dict`, `random_i3d_state_dict`, and a VGG16 + lpips-heads one made
here) are saved as `.pth` files and converted by both packages'
converters: the `.npz` arrays must be equal bit for bit (the same float64
folds). Then the same seeded numpy inputs go through both networks:
InceptionV3 through the JAX `_pool3_features` at 2 x 75 x 75 (the
network's smallest input; the 299 resize is held separately at the
borders of an upsample and a downsample), I3D through `i3d_features` at
1 x 9 x 224 x 224. The Frechet distance and `FeatureStats` are float64
numpy on both sides.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.ops import _provenance as jax_prov
from slotdiffusion_tpu.ops import fid as jax_fid
from slotdiffusion_tpu.ops import fvd as jax_fvd
from slotdiffusion_tpu.ops import lpips as jax_lpips
from slotdiffusion_tpu_torch.ops import _provenance as prov
from slotdiffusion_tpu_torch.ops import fid, fvd, lpips

# f32 convolutions summed in another order through ~20 (Inception) or
# ~22 (I3D) layers, relative to the features' scale
FEAT_TOL = 1e-4
# bilinear weights: JAX forms them by a normalised triangle kernel, torch
# by a clamped source index; both are exact to f32 rounding
RESIZE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded .pth files of each network and both converters' .npz."""
    d = tmp_path_factory.mktemp("metric_weights")
    out = {}
    for name, sd, port_conv, jax_conv in (
            ("inception", fid.random_inception_state_dict(0),
             fid.convert_torch_inception_npz,
             jax_fid.convert_torch_inception_npz),
            ("i3d", fvd.random_i3d_state_dict(0), fvd.convert_torch_i3d_npz,
             jax_fvd.convert_torch_i3d_npz)):
        pth = str(d / f"{name}.pth")
        torch.save(sd, pth)
        out[name] = dict(pth=pth, port=port_conv(pth, str(d / f"{name}.npz")),
                         jax=jax_conv(pth, str(d / f"{name}_jax.npz")))
    # torchvision VGG16's `features.N` (13 convs) and lpips' heads
    g = torch.Generator().manual_seed(0)
    vgg, lp, cin, idx = {}, {}, 3, 0
    for spec in lpips._VGG_CFG:
        if spec == "M":
            idx += 1
            continue
        vgg[f"features.{idx}.weight"] = torch.randn(spec, cin, 3, 3,
                                                    generator=g) * 0.05
        vgg[f"features.{idx}.bias"] = torch.randn(spec, generator=g) * 0.1
        cin, idx = spec, idx + 2
    convs = [c for c in lpips._VGG_CFG if c != "M"]
    for j, tap in enumerate(lpips._TAPS):
        lp[f"lin{j}.model.1.weight"] = torch.rand(1, convs[tap], 1, 1,
                                                  generator=g)
    vp, lpp = str(d / "vgg16.pth"), str(d / "lpips_heads.pth")
    torch.save(vgg, vp)
    torch.save(lp, lpp)
    out["lpips"] = dict(
        pth=vp, port=lpips.convert_torch_lpips_npz(vp, lpp,
                                                   str(d / "lpips.npz")),
        jax=jax_lpips.convert_torch_lpips_npz(vp, lpp,
                                              str(d / "lpips_jax.npz")))
    out["dir"] = d
    return out


@pytest.mark.parametrize("name", ["inception", "i3d", "lpips"])
def test_converters_match_jax_bit_for_bit(files, name):
    """Every array of the port's converted .npz (and the source sha)
    equals the JAX converter's, bit for bit."""
    with np.load(files[name]["port"]) as a, np.load(files[name]["jax"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert str(a["__source_sha256__"]) == jax_prov.file_sha256(
            files[name]["pth"])


def test_lpips_converter_orders_convs_numerically(files):
    """conv{i} is the i-th conv of VGG16 (features.0, .2, .5, ..., .28):
    its weight's shape follows the channel plan, so `features.10` did not
    sort before `features.2`."""
    convs = [c for c in lpips._VGG_CFG if c != "M"]
    with np.load(files["lpips"]["port"]) as a:
        cin = 3
        for i, c in enumerate(convs):
            assert a[f"conv{i}_w"].shape == (c, cin, 3, 3), i
            cin = c


def test_stand_in_npz_is_the_folded_state_dict(files, tmp_path):
    """`save_random_*_npz` writes the converter's arrays of the same seeded
    state dict, without the source sha (so the label is untrained)."""
    for name, save in (("inception", fid.save_random_inception_npz),
                       ("i3d", fvd.save_random_i3d_npz)):
        path = save(str(tmp_path / f"{name}_rand.npz"), seed=0)
        with np.load(path) as a, np.load(files[name]["port"]) as b:
            assert set(b.files) - set(a.files) == {"__source_sha256__"}
            for k in a.files:
                assert np.array_equal(a[k], b[k]), k


def test_weights_labels_match_jax(files, tmp_path, monkeypatch):
    """The three label forms (untrained, UNVERIFIED, src) of each metric,
    by explicit path and by the environment, against the JAX package's
    `weights_label` on the same files."""
    rand = fid.save_random_inception_npz(str(tmp_path / "r.npz"))
    pinned = str(tmp_path / "pinned.npz")
    np.savez(pinned, __source_sha256__="6726825d" + "0" * 56)
    cases = [(fid, jax_fid, "FID", files["inception"]["port"]),
             (fid, jax_fid, "FID", rand), (fid, jax_fid, "FID", pinned),
             (fvd, jax_fvd, "FVD", files["i3d"]["port"]),
             (fvd, jax_fvd, "FVD", rand),
             (lpips, jax_lpips, "lpips", files["lpips"]["port"]),
             (lpips, jax_lpips, "lpips", rand)]
    for mine, ref, name, path in cases:
        monkeypatch.setenv(mine.WEIGHTS_ENV, path)
        want = ref.weights_label(name)
        assert mine.weights_label(name) == want
        assert mine.weights_label(name, path) == want
        assert prov.weights_label(name, path) == jax_prov.weights_label(
            name, path)
    assert fid.weights_label("FID", rand) == "FID(untrained-weights)"
    assert fid.weights_label("FID", str(tmp_path / "none.npz")) == \
        "FID(untrained-weights)"
    assert fid.weights_label("FID", pinned) == "FID[src=6726825d]"
    assert fid.weights_label("FID", files["inception"]["port"]).startswith(
        "FID[UNVERIFIED src=")
    assert fvd.weights_label("FVD", files["i3d"]["port"]).startswith(
        "FVD[src=")


def _jax_params(npz):
    with np.load(npz) as data:
        return {p: (jnp.asarray(data[f"{p}_w"]), jnp.asarray(data[f"{p}_b"]))
                for p in jax_fid._CONV_SPEC}


def test_inception_pool3_matches_jax_at_75(files):
    """pool3 features of 2 images of 75 x 75 in [-1, 1] through the JAX
    `_pool3_features` and the port's network: within FEAT_TOL of their
    scale."""
    x = np.random.RandomState(7).rand(2, 75, 75, 3).astype(np.float32) * 2 \
        - 1
    want = np.asarray(jax.jit(jax_fid._pool3_features)(
        jnp.asarray(x), _jax_params(files["inception"]["port"])))
    net = fid.load_inception(files["inception"]["port"], "cpu")
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    assert got.shape == want.shape == (2, fid.DIM)
    scale = np.abs(want).max()
    assert 0.1 < scale < 1e3  # He-scaled: O(1) features
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL * scale)


@pytest.mark.parametrize("side", [64, 128, 320])
def test_resize_to_299_matches_jax(side):
    """The 299 resize of 2 images (upsampling from 64 and 128,
    downsampling from 320) against `jax.image.resize(..., "bilinear",
    antialias=False)`, borders included."""
    x = np.random.RandomState(side).rand(2, side, side, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       "bilinear", antialias=False))
    got = fid.resize_bilinear(torch.from_numpy(x), 299).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)
    for edge in (got[:, :2], got[:, -2:], got[:, :, :2], got[:, :, -2:]):
        assert np.isfinite(edge).all()


def test_i3d_features_match_jax(files, monkeypatch):
    """FVD features of 1 clip of 9 frames at 224 x 224 (the shortest the
    network takes) through the JAX `i3d_features` and the port's: within
    FEAT_TOL of their scale; fewer frames raise."""
    x = np.random.RandomState(3).rand(1, 9, 224, 224, 3).astype(np.float32)
    monkeypatch.setenv(jax_fvd.WEIGHTS_ENV, files["i3d"]["port"])
    jax_fvd._load_weights.cache_clear()
    try:
        want = np.asarray(jax_fvd.i3d_features(jnp.asarray(x)))
    finally:
        jax_fvd._load_weights.cache_clear()
    got = fvd.i3d_features(torch.from_numpy(x), files["i3d"]["port"]).numpy()
    assert got.shape == want.shape == (1, fvd.DIM)
    scale = np.abs(want).max()
    assert 0.01 < scale < 1e3
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL * scale)
    with pytest.raises(ValueError):
        fvd.i3d_features(torch.zeros(1, 8, 16, 16, 3), files["i3d"]["port"])


@pytest.mark.parametrize("kernel,stride,n", [
    ((7, 7, 7), (2, 2, 2), 16), ((1, 3, 3), (1, 2, 2), 112),
    ((3, 3, 3), (2, 2, 2), 28), ((2, 2, 2), (2, 2, 2), 14),
    ((3, 3, 3), (1, 1, 1), 7), ((2, 2, 2), (2, 2, 2), 3)])
def test_same_padding_matches_lax(kernel, stride, n):
    """TF "SAME" as `jax.lax` pads it (the extra value at the end): the
    max pool padded with -inf over a negative input, and the pad
    amounts, against `lax.reduce_window(..., "SAME")`."""
    x = -np.random.RandomState(n).rand(1, 2, n, n, n).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 1, *kernel),
        (1, 1, *stride), "SAME"))
    got = fvd.I3D.max_pool(torch.from_numpy(x), kernel, stride).numpy()
    np.testing.assert_array_equal(got, want)
    pads = jax.lax.padtype_to_pads((n, n, n), kernel, stride, "SAME")
    flat = fvd.same_pads((n, n, n), kernel, stride)
    assert [tuple(p) for p in pads] == [
        (flat[2 * i], flat[2 * i + 1]) for i in (2, 1, 0)]


def test_frechet_and_stats_match_jax():
    """`FeatureStats` streamed over chunks, its state_dict round trip, and
    `frechet_distance` / `fid_from_features` / `fvd_from_features` on
    seeded float64 features: equal to the JAX package's (the same numpy
    and scipy calls)."""
    rng = np.random.RandomState(0)
    a, b = rng.randn(40, 12), rng.randn(30, 12) * 1.5 + 0.3
    mine, ref = fid.FeatureStats(12), jax_fid.FeatureStats(12)
    for chunk in np.array_split(a, 4):
        mine.update(torch.from_numpy(chunk))
        ref.update(chunk)
    back = fid.FeatureStats(12)
    back.load_state_dict(mine.state_dict())
    for x, y in zip(back.finalize(), ref.finalize()):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)
    mu2, s2 = jax_fid.FeatureStats(12), None
    mu2.update(b)
    m2, s2 = mu2.finalize()
    d = fid.frechet_distance(*back.finalize(), m2, s2)
    assert abs(d - jax_fid.frechet_distance(*ref.finalize(), m2, s2)) <= \
        1e-9 * abs(d)
    assert abs(fid.fid_from_features(a, b) - jax_fid.fid_from_features(
        a, b)) <= 1e-9 * abs(d)
    assert abs(fvd.fvd_from_features(a, b) - jax_fvd.fvd_from_features(
        a, b)) <= 1e-9 * abs(d)
    # a singular product takes the eps * I retry on both sides
    low = np.repeat(rng.randn(5, 1), 12, axis=1)
    assert np.isfinite(fid.fid_from_features(low, low + 1e-3))
    with pytest.raises(ValueError):
        fid.FeatureStats(3).finalize()


def test_feature_functions_take_the_environment(files, monkeypatch):
    """With the environment variables set, `inception_available` /
    `i3d_available` hold and the feature functions read those files
    (the script path); 2 images of 32 x 32 give [2, 2048]."""
    monkeypatch.setenv(fid.WEIGHTS_ENV, files["inception"]["port"])
    monkeypatch.setenv(fvd.WEIGHTS_ENV, files["i3d"]["port"])
    assert fid.inception_available() and fvd.i3d_available()
    f = fid.inception_pool3_features(torch.rand(2, 32, 32, 3))
    assert f.shape == (2, fid.DIM) and torch.isfinite(f).all()
    monkeypatch.delenv(fid.WEIGHTS_ENV)
    assert not fid.inception_available()
    assert os.path.isfile(fvd.weights_path())
