"""The repo's SA trained on its generated COCO and VOC trees, in the port,
against the JAX package, on the CPU.

`checkpoint/sa_coco_file-res64/ckpt_final` and
`checkpoint/sa_voc_file-res64/ckpt_final` are exported by
`scripts/export_torch_checkpoint.py`, loaded strictly into the port's
`SACOCOFile64` and `SAVOCFile64` (every tensor equal to `convert_model`
of the restored tree), and `scripts/test_seg_torch.py` runs them over a
validation tree that `scripts/data_utils/gen_mini_seg_data.py` writes
(8 COCO images, 4 VOC ones, at 96x96 as the training trees). Its
`inst/*` and `sem/*` numbers must equal, within 1e-4, the JAX
`seg_metrics_fn` over the JAX model's outputs on the JAX datasets'
batches of the same tree: what the JAX scripts/test_seg.py computes.
(The JAX training logs end at val/inst/fari 0.2995, COCO, and 0.1071,
VOC, on their own trees.)
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.data.coco import COCODataset as JaxCOCO
from slotdiffusion_tpu.data.coco import coco_collate_fn as jax_collate
from slotdiffusion_tpu.data.voc import VOCDataset as JaxVOC
from slotdiffusion_tpu.methods.build import seg_metrics_fn as jax_seg_metrics
from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.training.checkpoint import load_model_params
from slotdiffusion_tpu.utils import load_params
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import convert_model
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.training.checkpoint import load_model_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"coco": ("SACOCOFile64", "configs/sa_coco_file-res64.py",
                   "checkpoint/sa_coco_file-res64/ckpt_final"),
          "voc": ("SAVOCFile64", "configs/sa_voc_file-res64.py",
                  "checkpoint/sa_voc_file-res64/ckpt_final")}
METRIC_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _script(path, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    gen = _script("scripts/data_utils/gen_mini_seg_data.py",
                  "gen_mini_seg_data")
    gen.gen_coco(str(root / "coco"), 1, 8, 96)
    gen.gen_voc(str(root / "voc"), 16, 96)
    return root


@pytest.mark.parametrize("key", ["coco", "voc"])
def test_trained_sa_exports_and_test_seg_matches_jax(key, trees,
                                                     tmp_path, capsys):
    name, jcfg, ckpt = MODELS[key]
    jcfg, ckpt = os.path.join(REPO, jcfg), os.path.join(REPO, ckpt)
    pt = str(tmp_path / "model.pt")
    export = _script("scripts/export_torch_checkpoint.py", "export_ckpt")
    state = export.export(jcfg, ckpt, pt)
    assert state["config"] == name
    cfg = configs.get_config(name)
    model = build_model(cfg, device="cpu")
    load_model_weights(model, pt)  # strict
    jparams = load_params(jcfg)
    jmodel = build_jax_model(jparams)
    jvars = load_model_params(jmodel, ckpt, jparams)
    want_sd = convert_model(jax.tree_util.tree_map(
        np.asarray, jvars["params"]), cfg)
    sd = model.state_dict()
    assert set(want_sd) == set(sd)
    assert all(torch.equal(sd[k], v) for k, v in want_sd.items())

    # the JAX path: its datasets' batches of 8 (COCO collater), its model,
    # its seg_metrics_fn, means weighted by batch size
    root = str(trees / key)
    jset = (JaxCOCO if key == "coco" else JaxVOC)(
        root, tuple(cfg.resolution), split="val")
    fwd = jax.jit(lambda v, x: jmodel.apply(v, {"img": x}, train=False))
    sums, n = {}, 0
    for lo in range(0, len(jset), 8):
        samples = [jset[i] for i in range(lo, min(lo + 8, len(jset)))]
        batch = jax_collate(samples) if key == "coco" else {
            k: np.stack([s[k] for s in samples]) for k in samples[0]}
        out = jax.device_get(fwd(jvars, batch["img"]))
        bs = len(samples)
        for k, v in jax_seg_metrics(batch, out).items():
            sums[k] = sums.get(k, 0.0) + v * bs
        n += bs
    want = {k: v / n for k, v in sums.items()}
    assert len(want) == 10 and n == (8 if key == "coco" else 4)

    seg = _script("scripts/test_seg_torch.py", "test_seg_torch").main(
        ["--params", name, "--weight", pt, "--data_root", root, "--split",
         "val", "--bs", "8", "--cpu", "--num_workers", "0"])[0]
    assert "FINAL inst/ari=" in capsys.readouterr().out
    assert set(seg) == set(want)
    for k, w in want.items():
        assert abs(seg[k] - w) <= METRIC_TOL, (k, seg[k], w)
