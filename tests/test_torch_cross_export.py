"""Artifacts exported for a device the host lacks (`serving.save_artifact(
devices=...)`, the JAX exporter's `platforms`), on this CPU-only host.

The tiny SAViDiffusion (the flagship's kernel knobs, seeded random
weights) is traced once on the CPU and written with a program set for
`cuda` and one for `cpu`:

- the header names both devices and every program's device (`encode`,
  `denoise`; `sample`'s three programs for the card alone);
- the CPU programs answer as the live surface does, bit for bit;
- the `cuda` programs hold the `sdt::` operators and nothing of the CPU:
  no node's device argument or tensor metadata names it and no lifted
  constant is left behind (weights are moved to the card at load);
- loading the `cuda` programs here raises the RuntimeError `load_artifact`
  gives without a card, and asking for a device the artifact lacks the
  ValueError;
- a header of one `device` (written before `devices`) still loads.
"""

import io
import json

import pytest
import torch

from slotdiffusion_tpu_torch import configs, serving
from slotdiffusion_tpu_torch.models import build_model, init_random_
from torch_parity_helpers import RES, SLOT_SIZE, SLOTS, T_FRAMES

SHAPE = (2, T_FRAMES, *RES, 3)
SDT = {"encode": {"sdt.sa_iterations.default"},
       "denoise": {"sdt.group_norm.default", "sdt.mha.default"},
       "sample": {"sdt.group_norm.default", "sdt.mha.default"}}


@pytest.fixture(scope="module")
def model():
    m = build_model(configs.tiny_config(RES, SLOTS, SLOT_SIZE, 50),
                    device="cpu")
    return init_random_(m, torch.Generator().manual_seed(0))


def _read(path):
    with open(path, "rb") as f:
        header = json.loads(f.readline().decode())
        blobs = [(p, f.read(p["bytes"])) for p in header["programs"]]
    return header, blobs


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def _cuda_programs_hold_no_cpu(path, what):
    """The artifact's cuda programs: the kernels' operators, nothing of
    the CPU."""
    ops = set()
    for p, blob in _read(path)[1]:
        if p["device"] != "cuda":
            continue
        ep = torch.export.load(io.BytesIO(blob))
        for node in ep.graph.nodes:
            if node.op == "call_function" and "sdt" in str(node.target):
                ops.add(str(node.target))
            assert "cpu" not in str(node.kwargs.get("device", "")), node
            val = node.meta.get("val")
            vals = val if isinstance(val, (tuple, list)) else [val]
            assert all(v.device.type == "cuda" for v in vals
                       if isinstance(v, torch.Tensor)), node
        assert not ep.constants
    assert ops >= SDT[what]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serving.load_artifact(path, "cuda")


@pytest.mark.parametrize("what", ["encode", "denoise"])
def test_one_trace_gives_a_cuda_and_a_cpu_program(model, tmp_path, what):
    fn, example = serving.build_serving_fn(model, what, SHAPE)
    path = str(tmp_path / f"{what}.pt2")
    header = serving.save_artifact(path, fn, example, meta={"what": what},
                                   devices=("cuda", "cpu"))
    assert header["devices"] == ["cuda", "cpu"]
    assert header["traced_on"] == "cpu" and header["device"] == "cuda"
    names = [p["name"] for p in header["programs"] if p["device"] == "cuda"]
    assert names == [p["name"] for p in header["programs"]
                     if p["device"] == "cpu"] == ["main"]
    # the CPU programs answer as the live surface does
    call, header2 = serving.load_artifact(path, "cpu")
    assert header2 == header
    _same(call(*example), fn(*example))
    if what == "encode":
        video = torch.rand(SHAPE, generator=torch.Generator().manual_seed(2))
        _same(call(video), fn(video))
    _cuda_programs_hold_no_cpu(path, what)


def test_sample_for_the_card_holds_its_three_programs(model, tmp_path):
    """`sample`'s UNet step, VQ quantize and VQ decode, each retargeted
    for the card from the one CPU trace (its CPU twin is the one-device
    export the serving tests hold)."""
    fn, example = serving.build_serving_fn(model, "sample", SHAPE)
    path = str(tmp_path / "sample.pt2")
    header = serving.save_artifact(path, fn, example, devices=("cuda",))
    assert [(p["name"], p["device"]) for p in header["programs"]] == [
        ("denoise", "cuda"), ("quantize", "cuda"), ("decode", "cuda")]
    assert header["sampler"]["code"] == fn.module.sampler["code"]
    _cuda_programs_hold_no_cpu(path, "sample")


def test_a_device_the_artifact_lacks_is_refused(model, tmp_path):
    fn, example = serving.build_serving_fn(model, "encode", SHAPE)
    path = str(tmp_path / "cuda_only.pt2")
    header = serving.save_artifact(path, fn, example, devices=("cuda",))
    assert header["devices"] == ["cuda"] and header["traced_on"] == "cpu"
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        serving.load_artifact(path, "cpu")


def test_a_one_device_header_still_loads(model, tmp_path):
    """An artifact written before `devices`: its header names one
    `device` and its programs no device."""
    fn, example = serving.build_serving_fn(model, "denoise", SHAPE)
    path = tmp_path / "new.pt2"
    serving.save_artifact(str(path), fn, example)
    header, blobs = _read(path)
    old = {k: v for k, v in header.items()
           if k not in ("devices", "traced_on")}
    old["programs"] = [{"name": p["name"], "bytes": p["bytes"]}
                       for p, _ in blobs]
    old_path = tmp_path / "old.pt2"
    old_path.write_bytes((json.dumps(old) + "\n").encode() +
                         b"".join(b for _, b in blobs))
    assert serving.artifact_devices(old) == ["cpu"]
    call, got = serving.load_artifact(str(old_path))
    assert got == old
    _same(call(*example), fn(*example))
