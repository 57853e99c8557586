"""Serving in the port (slotdiffusion_tpu_torch/serving.py,
scripts/serve_model_torch.py), on the CPU at a tiny width: the cases of
tests/test_serving.py, and the parts the port adds.

- Artifact round trips (`save_artifact` -> `load_artifact`) of `encode`,
  `denoise` and `sample` equal the port's eager path bit for bit: the
  exported programs run the same CPU operators, the kernels as their
  `sdt::` operators, whose CPU implementations are the plain versions.
- `encode` and `denoise` through the port equal the JAX package's
  `build_serving_fn` on converted weights.
- `sample` repeats for a seed, moves with it, and folds a video's T.
- The HTTP server answers /health and /predict, and a wrong shape gets a
  400; a file that is not an artifact, an artifact for a device that
  is not here, and a `sample` artifact made for another sampler are
  refused.
- Each `sdt::` operator's fake implementation gives its plain version's
  shape and dtype, in f32 and bf16.
- A CUDA graph cache drops its graphs when a weight's storage moves, and
  keeps them across an in-place copy; launch counts carry over a replay.
"""

import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from slotdiffusion_tpu import serving as jax_serving
from slotdiffusion_tpu_torch import configs, ops, serving
from slotdiffusion_tpu_torch.models import build_model, init_random_
from slotdiffusion_tpu_torch.ops import (attention_kernel, dpm_solver,
                                         fused_norm, slot_attention_kernel)
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, T_FRAMES,
                                  build_pair, t2n, video)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, T_FRAMES, *RES, 3)
# f32 on both sides with the same formulas, summed in another order
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    """The tiny SAViDiffusion with the flagship's kernel knobs (GN,
    attention and slot attention through their wrappers), seeded random
    weights."""
    m = build_model(configs.tiny_config(RES, SLOTS, SLOT_SIZE, 50),
                    device="cpu")
    return init_random_(m, torch.Generator().manual_seed(0))


def _roundtrip(model, what, tmp_path):
    fn, example = serving.build_serving_fn(model, what, SHAPE)
    path = str(tmp_path / f"{what}.pt2")
    header = serving.save_artifact(path, fn, example, meta={"what": what})
    call, header2 = serving.load_artifact(path)
    assert header2 == header and header["device"] == "cpu"
    return fn, example, call, header


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _assert_same(a, b):
    for x, y in zip(_as_tuple(a), _as_tuple(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_export_encode_roundtrip(model, tmp_path):
    fn, example, call, header = _roundtrip(model, "encode", tmp_path)
    assert header["args"] == [{"shape": list(SHAPE), "dtype": "float32"}]
    assert [p["name"] for p in header["programs"]] == ["main"]
    img = torch.from_numpy(video(4, B=2))
    slots, masks = call(img)
    assert slots.shape == (2, T_FRAMES, SLOTS, SLOT_SIZE)
    assert masks.shape == (2, T_FRAMES, SLOTS, *RES)
    _assert_same((slots, masks), fn(img))


def test_export_denoise_roundtrip(model, tmp_path):
    fn, example, call, _ = _roundtrip(model, "denoise", tmp_path)
    x, t, slots = example
    assert x.shape == (2 * T_FRAMES, RES[0] // 4, RES[1] // 4, 3)
    r = np.random.RandomState(0)
    args = (torch.from_numpy(r.randn(*x.shape).astype(np.float32)),
            torch.full(t.shape, 25.5),
            torch.from_numpy(r.randn(*slots.shape).astype(np.float32)))
    _assert_same(call(*args), fn(*args))


def test_export_sample_deterministic(model, tmp_path):
    """The artifact's `sample` is the UNet step, the VQ quantize and the
    VQ decode exported apart, chained by the port's DPM-Solver++ with the
    schedule in the header: the same chain, step for step, as the live
    surface; x_T comes from the seed in both."""
    fn, example, call, header = _roundtrip(model, "sample", tmp_path)
    assert [p["name"] for p in header["programs"]] == [
        "denoise", "quantize", "decode"]
    assert header["args"][0] == {"shape": [], "dtype": "int32"}
    assert header["sampler"]["steps"] == 20
    assert header["sampler"]["code"] == dpm_solver.SAMPLER
    slots = torch.from_numpy(np.random.RandomState(1).randn(
        *example[1].shape).astype(np.float32))
    live = fn(np.int32(7), slots)
    exp = call(np.int32(7), slots)
    _assert_same(exp, live)
    _assert_same(call(7, slots), exp)
    other = call(8, slots)
    assert (other - exp).abs().max().item() > 1e-4


def test_export_video_sample_folds_time(model):
    """Video slots [B, T, S, D]: the chain runs over the B*T frames and the
    images come back as [B, T, H, W, 3]; frame (b, t) is what the chain
    gives for that frame's slots and its row of x_T."""
    fn = serving.build_serving_fn(model, "sample")
    slots = torch.randn(1, T_FRAMES, SLOTS, SLOT_SIZE,
                        generator=torch.Generator().manual_seed(2))
    out = fn(0, slots)
    assert out.shape == (1, T_FRAMES, *RES, 3) and torch.isfinite(out).all()
    flat = fn(0, slots[0])  # the same frames folded by the caller
    _assert_same(out[0], flat)


@pytest.fixture(scope="module")
def pair():
    return build_pair(use_pallas=False)


@pytest.mark.parametrize("what", ["encode", "denoise"])
def test_port_matches_jax_build_serving_fn(pair, what):
    """The JAX package's surface on its model and the port's on the
    converted weights (slot attention's f32 formula on both sides, as the
    JAX model takes it off the TPU): f32, the same formulas, sums in
    another order, TOL."""
    cfg, jmodel, jvars, tmodel = pair
    jfn, jexample = jax_serving.build_serving_fn(jmodel, jvars, what,
                                                 SHAPE)
    fn, example = serving.build_serving_fn(tmodel, what, SHAPE)
    assert [tuple(a.shape) for a in example] == \
        [tuple(np.shape(a)) for a in jexample]
    r = np.random.RandomState(3)
    if what == "encode":
        args = (video(5, B=2),)
    else:
        x, _, s = example
        args = (r.randn(*x.shape).astype(np.float32),
                np.arange(x.shape[0], dtype=np.int32) * 11,
                r.randn(*s.shape).astype(np.float32))
    ref = jfn(*[jnp.asarray(a) for a in args])
    out = fn(*[torch.from_numpy(a) for a in args])
    for a, b in zip(_as_tuple(out), _as_tuple(ref), strict=True):
        np.testing.assert_allclose(t2n(a), np.asarray(b), **TOL)


def _post(base, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"{base}/predict", buf.getvalue(),
                                 method="POST")
    return np.load(io.BytesIO(urllib.request.urlopen(req, timeout=60)
                              .read()))


def test_http_server_roundtrip(model, tmp_path):
    """scripts/serve_model_torch.py: /health and /predict over a live
    local server against an exported encode artifact, and a 400 that
    names the argument for a wrong shape."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from serve_model_torch import make_server

    fn, example, _, _ = _roundtrip(model, "encode", tmp_path)
    srv = make_server(str(tmp_path / "encode.pt2"), port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        health = json.loads(urllib.request.urlopen(f"{base}/health",
                                                   timeout=30).read())
        assert health["status"] == "ok" and health["surface"] == "encode"
        assert health["meta"]["what"] == "encode"
        img = video(6, B=2)
        out = _post(base, arg0=img)
        live_slots, live_masks = fn(torch.from_numpy(img))
        np.testing.assert_array_equal(out["out0"], t2n(live_slots))
        np.testing.assert_array_equal(out["out1"], t2n(live_masks))
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, arg0=img[:1])
        assert err.value.code == 400 and b"arg0" in err.value.read()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


def test_load_rejects_non_artifact(tmp_path):
    p = tmp_path / "junk.pt2"
    p.write_bytes(b'{"magic": "nope"}\nxx')
    with pytest.raises(ValueError):
        serving.load_artifact(str(p))
    p.write_bytes(b"\x89PNG\r\n\x1a\n\x00\x00")
    with pytest.raises(ValueError):
        serving.load_artifact(str(p))


def test_load_rejects_an_artifact_for_another_device(model, tmp_path):
    """An artifact names the device it was exported for; loading it where
    that device is missing, or asking for another, raises before reading
    the program."""
    _, _, _, header = _roundtrip(model, "encode", tmp_path)
    with pytest.raises(ValueError, match="exported for cpu"):
        serving.load_artifact(str(tmp_path / "encode.pt2"), "cuda")
    cuda = dict(header, device="cuda")
    p = tmp_path / "cuda.pt2"
    p.write_bytes((json.dumps(cuda) + "\n").encode())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serving.load_artifact(str(p))


def test_load_rejects_a_sample_artifact_for_another_sampler(tmp_path):
    """A `sample` artifact holds the UNet step and the VQ-VAE, not the
    sampler: the loading port chains them. One made for another sampler
    (`dpm_solver.SAMPLER`) is refused before its programs are read."""
    header = {"magic": serving.MAGIC, "surface": "sample", "device": "cpu",
              "programs": [], "sampler": {"code": "dpmsolver-multistep-v0"}}
    p = tmp_path / "old.pt2"
    p.write_bytes((json.dumps(header) + "\n").encode())
    with pytest.raises(ValueError, match="sampler"):
        serving.load_artifact(str(p))


def _gn_args(dtype):
    x = torch.randn(2, 64, 4, 4).to(dtype)
    return (x, torch.ones(64), torch.zeros(64), 32, 1e-5, True), \
        lambda *a: fused_norm.group_norm_reference(*a[:5], "silu")


def _mha_args(dtype):
    q = torch.randn(2, 16, 64).to(dtype)
    k = torch.randn(2, 5, 64).to(dtype)
    return (q, k, k, 2, None), attention_kernel.mha_reference


def _sa_args(dtype):
    D, M = 8, 16
    shapes = {"wq": (D, D), "gru_wi": (D, 3 * D), "gru_wh": (D, 3 * D),
              "w1": (D, M), "w2": (M, D), "gru_bi": (3 * D,),
              "gru_bh": (3 * D,), "b1": (M,)}
    w = [torch.randn(shapes.get(k, (D,)))
         for k in slot_attention_kernel.SA_WEIGHT_KEYS]
    k = torch.randn(2, 20, D).to(dtype)
    slots = torch.randn(2, 3, D).to(dtype)

    def plain(k, v, s, w, iters, eps, ret, kv):
        return slot_attention_kernel.sa_iterations_ref(
            k, v, s, dict(zip(slot_attention_kernel.SA_WEIGHT_KEYS, w)),
            num_iterations=iters, eps=eps, return_last_attn=ret,
            kv_dtype=kv)
    return (k, k, slots, w, 2, 1e-6, True, torch.bfloat16), plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("op,make", [
    (torch.ops.sdt.group_norm, _gn_args), (torch.ops.sdt.mha, _mha_args),
    (torch.ops.sdt.sa_iterations, _sa_args)], ids=["gn", "mha", "sa"])
def test_operator_fake_matches_plain_version(op, make, dtype):
    """torch.export traces a kernel through its operator's fake
    implementation: its outputs must have the plain version's shapes and
    dtypes (GN and attention return the input's dtype, slot attention f32
    slots and mask); the CPU implementation is the plain version."""
    args, plain = make(dtype)
    ref = _as_tuple(plain(*args))
    real = _as_tuple(op(*args))
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if torch.is_tensor(a) else
                     [mode.from_tensor(t) for t in a]
                     if isinstance(a, list) else a for a in args]
        fake = _as_tuple(op(*fake_args))
    for r, x, f in zip(ref, real, fake):
        assert (f.shape, f.dtype) == (r.shape, r.dtype)
        assert torch.equal(x, r)


def test_graph_cache_follows_the_weights(model):
    """A CUDA graph reads the weights by address: an in-place copy (the
    EMA swap, `load_state_dict`) keeps the cached graphs, a parameter
    whose storage is replaced drops them. Checked on the cache's own
    bookkeeping (capturing needs a card)."""
    enc = serving._Encode(model)
    cache = serving.CudaGraphed(enc, enc)
    cache.graphs["sentinel"] = None
    sd = {k: v.clone() for k, v in enc.state_dict().items()}
    with torch.no_grad():
        enc.load_state_dict(sd)
    cache.drop_if_weights_moved()
    assert "sentinel" in cache.graphs
    p = next(enc.parameters())
    p.data = p.data.clone()
    cache.drop_if_weights_moved()
    assert not cache.graphs


def test_launch_counts_carry_over_a_replay():
    """What a capture counted is taken back (a capture runs nothing) and
    added at every replay."""
    ops.reset_launch_counts()
    before = ops.launches_by_entry()
    fused_norm.launches["sdt_group_norm_f32"] += 3  # a capture's count
    launched = ops.launches_since(before)
    assert launched["sdt_group_norm_f32"] == 3
    ops.add_launches({k: -n for k, n in launched.items()})
    assert not any(ops.launch_counts().values())
    ops.add_launches(launched)
    ops.add_launches(launched)
    assert ops.launch_counts()["gn_silu"] == 6
    ops.reset_launch_counts()
