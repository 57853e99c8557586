"""test_recon of the port (`scripts/test_recon_torch.py`,
`slotdiffusion_tpu_torch/methods/evaluation.py`) against the JAX
package's `scripts/test_recon.py` on the CPU.

Both scripts run on the trained `checkpoint/sa_synthetic_long-res64/
ckpt_final` (the port on its export) over the same 4 val images in 2
batches, with a seeded LPIPS `.npz` (`save_random_lpips_npz`, the same
array for array on both sides) and a seeded stand-in Inception
(`save_random_inception_npz`), `--fid` and `--save_video`. Each writes
its per-batch cache; the caches must hold the same keys (the LPIPS key
under its label, `_fid`) and values within the tolerances below, the
FINAL lines the same metrics, and the frame dumps the same images. A
second port run over its cache computes nothing. The Frechet distance of
2048-d features (scipy's sqrtm, ~15 s a call here) is replaced on both
sides by one stand-in of the same statistics, whose inputs the test
compares; the distance itself is held in tests/test_torch_fid_fvd.py.
Then FVD's cached features on clips of 9 frames of a tiny seeded SAVi,
and the warning for shorter clips.
"""

import contextlib
import importlib.util
import io
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from slotdiffusion_tpu.ops import fid as jax_fid
from slotdiffusion_tpu.ops import lpips as jax_lpips
from slotdiffusion_tpu_torch.methods import evaluation
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.ops import fid, fvd, lpips
from torch_parity_helpers import tiny_baseline_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CFG = os.path.join(REPO, "configs", "sa_synthetic_long-res64.py")
CKPT = os.path.join(REPO, "checkpoint", "sa_synthetic_long-res64",
                    "ckpt_final")
# the reconstructions agree to ~2e-5 (tests/test_torch_trained_images.py),
# so the metrics of them to 1e-4 relative; Inception's features to 1e-4
# of their scale (tests/test_torch_fid_fvd.py)
METRIC_RTOL, FEAT_TOL = 1e-4, 1e-4
# the JAX FINAL line prints 4 decimals
PRINTED = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stand_in(calls):
    """A cheap Frechet stand-in of the same statistics, recording them."""
    def frechet(mu1, s1, mu2, s2, eps=1e-6):
        calls.append((mu1, s1, mu2, s2))
        return float(np.sum((mu1 - mu2) ** 2) + np.trace(s1) - np.trace(s2))
    return frechet


def _final(text):
    line = [ln for ln in text.splitlines() if ln.startswith("FINAL ")]
    assert len(line) == 1, text
    return {k: float(v) for k, v in (kv.split("=") for kv in
                                     line[0][6:].split())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts on the trained SA: -> dict of the port's and JAX's
    caches, FINAL lines, frame directories, and the port's arguments."""
    d = tmp_path_factory.mktemp("recon")
    pt = str(d / "model.pt")
    _script("export_torch_checkpoint").export(JAX_CFG, CKPT, pt)
    cfg = d / "recon_sa-res64.py"
    cfg.write_text(
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'configs')!r})\n"
        "from importlib import import_module\n"
        "_base = import_module('sa_synthetic_long-res64')\n\n\n"
        "class SlotAttentionParams(_base.SlotAttentionParams):\n"
        "    val_samples = 4\n"
        "    num_workers = 0\n")
    env = {lpips.WEIGHTS_ENV: lpips.save_random_lpips_npz(
               str(d / "lpips.npz"), seed=0),
           fid.WEIGHTS_ENV: fid.save_random_inception_npz(
               str(d / "inception.npz"), seed=0)}
    mp = pytest.MonkeyPatch()
    calls = {"jax": [], "port": []}
    try:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.delenv(fvd.WEIGHTS_ENV, raising=False)
        jax_lpips._load_weights.cache_clear()
        jax_fid._load_weights.cache_clear()
        mp.setattr(jax_fid, "frechet_distance", _stand_in(calls["jax"]))
        mp.setattr(fid, "frechet_distance", _stand_in(calls["port"]))
        mp.setattr("sys.argv", [
            "test_recon.py", "--params", str(cfg), "--weight", CKPT,
            "--bs", "2", "--fid", "--save_video", "--out_dir",
            str(d / "jax")])
        out = {}
        for side in ("jax", "port"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if side == "jax":
                    _script("test_recon").main()
                else:
                    out["port_final"] = _script("test_recon_torch").main(
                        port_args(pt, d))
            out[f"{side}_text"] = buf.getvalue()
    finally:
        mp.undo()
        jax_lpips._load_weights.cache_clear()
        jax_fid._load_weights.cache_clear()
    with open(d / "jax" / "recon_sa-res64.py.metrics.pkl", "rb") as f:
        out["jax_cache"] = pickle.load(f)
    with open(d / "port" / "SASyntheticLong64.metrics.pkl", "rb") as f:
        out["port_cache"] = pickle.load(f)
    out.update(dir=d, pt=pt, env=env, calls=calls,
               jax_frames=d / "jax" / "recon_sa-res64.py",
               port_frames=d / "port" / "SASyntheticLong64")
    return out


def port_args(pt, d):
    return ["--params", "SASyntheticLong64", "--weight", pt, "--bs", "2",
            "--max_batches", "2", "--fid", "--save_video", "--out_dir",
            str(d / "port"), "--cpu", "--num_workers", "0"]


def test_per_batch_results_match_jax(runs):
    """Each batch's cached results: the same keys in the same order (mse,
    psnr, ssim, `lpips(untrained-weights)`, `_fid`), the metrics within
    METRIC_RTOL, the raw Inception features of both sides within FEAT_TOL
    of their scale."""
    jc, pc = runs["jax_cache"], runs["port_cache"]
    assert sorted(jc) == sorted(pc) == [0, 1]
    for i in (0, 1):
        assert list(pc[i]) == list(jc[i]) == [
            "mse", "psnr", "ssim", "lpips(untrained-weights)", "_fid"]
        for k in ("mse", "psnr", "ssim", "lpips(untrained-weights)"):
            assert abs(pc[i][k] - jc[i][k]) <= METRIC_RTOL * abs(jc[i][k]), \
                (i, k, pc[i][k], jc[i][k])
        for got, want in zip(pc[i]["_fid"], jc[i]["_fid"]):
            assert got.shape == want.shape == (2, fid.DIM)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=FEAT_TOL * np.abs(want).max())


def test_final_lines_match_jax(runs):
    """The FINAL lines: the same metrics in the same order, the FID under
    `fid(untrained-weights)` from the same statistics (the stand-in's
    inputs: mean and covariance of each side)."""
    want, got = _final(runs["jax_text"]), _final(runs["port_text"])
    assert list(got) == list(want) == [
        "mse", "psnr", "ssim", "lpips(untrained-weights)",
        "fid(untrained-weights)"]
    for k, w in want.items():
        assert abs(got[k] - w) <= PRINTED + METRIC_RTOL * abs(w), (k, got[k],
                                                                  w)
        assert abs(runs["port_final"][k] - got[k]) <= PRINTED
    (jm1, js1, jm2, js2), = runs["calls"]["jax"]
    (pm1, ps1, pm2, ps2), = runs["calls"]["port"]
    for p, j in ((pm1, jm1), (pm2, jm2), (ps1, js1), (ps2, js2)):
        np.testing.assert_allclose(p, j, rtol=0,
                                   atol=1e-3 * np.abs(j).max())


def test_frame_dumps_match_jax(runs):
    """`--save_video`: `b{batch:04d}_{frame:03d}.png` for every frame on
    both sides, PIL decoding each port file (the port's own writer) to
    the JAX file's pixels, up to one 8-bit level where a reconstruction's
    ~2e-5 difference crosses a rounding step."""
    names = sorted(os.listdir(runs["jax_frames"]))
    assert names == [f"b{i:04d}_{j:03d}.png" for i in (0, 1) for j in (0, 1)]
    assert sorted(os.listdir(runs["port_frames"])) == names
    for n in names:
        a = np.asarray(Image.open(runs["port_frames"] / n)).astype(int)
        b = np.asarray(Image.open(runs["jax_frames"] / n)).astype(int)
        assert a.shape == b.shape == (64, 64, 3)
        assert np.abs(a - b).max() <= 1 and (a == b).mean() > 0.99, n


def test_resumed_run_computes_nothing(runs, monkeypatch, capsys):
    """A second port run over the same cache takes every batch from it: it
    reconstructs, scores and dumps nothing, and gives the same FINAL
    results."""
    def refuse(*a, **k):
        raise AssertionError("a cached batch was computed again")
    monkeypatch.setattr(evaluation, "recon_samples", refuse)
    monkeypatch.setattr(evaluation, "batch_results", refuse)
    monkeypatch.setattr(fid, "frechet_distance", _stand_in([]))
    for k, v in runs["env"].items():
        monkeypatch.setenv(k, v)
    before = sorted(os.listdir(runs["port_frames"]))
    final = _script("test_recon_torch").main(port_args(runs["pt"],
                                                       runs["dir"]))
    assert final == runs["port_final"]
    assert _final(capsys.readouterr().out) == _final(runs["port_text"])
    assert sorted(os.listdir(runs["port_frames"])) == before


def test_fvd_features_of_clips_are_cached(tmp_path, monkeypatch, capsys):
    """A video model (a tiny seeded SAVi) over a batch of 2 clips of 9
    frames: `_fvd` holds the I3D features of its reconstruction and of the
    clips, the FINAL line FVD under `fvd(untrained-weights)`; clips of 2
    frames take no FVD, which is said, and the FID of their frames still
    runs."""
    monkeypatch.setenv(fvd.WEIGHTS_ENV, fvd.save_random_i3d_npz(
        str(tmp_path / "i3d.npz")))
    monkeypatch.setenv(fid.WEIGHTS_ENV, fid.save_random_inception_npz(
        str(tmp_path / "inception.npz")))
    monkeypatch.delenv(lpips.WEIGHTS_ENV, raising=False)
    monkeypatch.setattr(fid, "frechet_distance", _stand_in([]))
    cfg = tiny_baseline_config("SAVi")
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu").eval()
    g = torch.Generator().manual_seed(0)
    clip = torch.rand(2, 9, 16, 16, 3, generator=g) * 2 - 1
    fid_fn, fvd_fn = evaluation.feature_fns(True, True)
    cache = str(tmp_path / "cache.pkl")
    final = evaluation.recon_eval(model, cfg, [{"img": clip}], cache, "cpu",
                                  None, fvd_fn, total=1)
    assert list(final) == ["mse", "psnr", "ssim", "fvd(untrained-weights)"]
    with open(cache, "rb") as f:
        cached = pickle.load(f)
    with torch.no_grad():
        x = (model({"img": clip})["recon_img"] * 0.5 + 0.5).clamp(0, 1)
    for got, want in zip(cached[0]["_fvd"], (x, (clip * 0.5 + 0.5).clamp(
            0, 1))):
        assert got.shape == (2, fvd.DIM)
        np.testing.assert_allclose(got, fvd.i3d_features(want).numpy(),
                                   rtol=0, atol=1e-6)
    final = evaluation.recon_eval(model, cfg, [{"img": clip[:, :2]}], str(
        tmp_path / "short.pkl"), "cpu", fid_fn, fvd_fn)
    text = capsys.readouterr().out
    assert "WARNING: T=2 < 9; I3D needs >= 9, skipping FVD" in text
    assert list(final) == ["mse", "psnr", "ssim", "fid(untrained-weights)"]


def test_missing_weights_are_said():
    """`--fid` / `--fvd` without their files: one warning each and no
    feature function, as the JAX scripts."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        env = {k: os.environ.pop(k, None)
               for k in (fid.WEIGHTS_ENV, fvd.WEIGHTS_ENV)}
        try:
            fns = evaluation.feature_fns(True, True)
        finally:
            os.environ.update({k: v for k, v in env.items() if v})
    assert fns == (None, None)
    assert buf.getvalue().splitlines() == [
        f"WARNING: --fid needs {fid.WEIGHTS_ENV}; skipping",
        f"WARNING: --fvd needs {fvd.WEIGHTS_ENV}; skipping"]
