"""COCO, VOC and the dual inst/sem protocol: the port against the JAX
package, on the CPU.

- The overlap preprocessing and every segmentation metric with and
  without `inst_overlap_mask`, and `seg_metrics_fn`'s `inst/*` and
  `sem/*` keys, equal to the JAX package's on the same masks (exact
  counts in float64 on both sides: 1e-12);
- the COCO annotation reader (compressed RLE both ways, polygons),
  `COCODataset` (val, and train at two epochs), `coco_collate_fn` and
  `VOCDataset` (val and trainaug) against the JAX classes sample by
  sample, on trees that `scripts/data_utils/gen_mini_seg_data.py`
  writes; `SyntheticCOCODataset` at the same seeds;
- the COCO and VOC configs against their JAX config files, and the
  224x224 ones built (on the meta device, nothing run) with their
  shapes checked.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from slotdiffusion_tpu.data import _coco_api as jax_api
from slotdiffusion_tpu.data.coco import COCODataset as JaxCOCO
from slotdiffusion_tpu.data.coco import coco_collate_fn as jax_collate
from slotdiffusion_tpu.data.synthetic import SyntheticCOCODataset as JaxSynth
from slotdiffusion_tpu.data.voc import VOCDataset as JaxVOC
from slotdiffusion_tpu.methods.build import seg_metrics_fn as jax_seg_metrics
from slotdiffusion_tpu.ops import metrics as JM
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.data import _coco_api as api
from slotdiffusion_tpu_torch.data import build_datamodule, collate_fn
from slotdiffusion_tpu_torch.data.coco import COCODataset, coco_collate_fn
from slotdiffusion_tpu_torch.data.synthetic import SyntheticCOCODataset
from slotdiffusion_tpu_torch.data.voc import VOCDataset
from slotdiffusion_tpu_torch.methods.build import seg_metrics_fn
from slotdiffusion_tpu_torch.ops import metrics as M
from test_torch_images import _plain, _same_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (32, 32)


def _gen():
    spec = importlib.util.spec_from_file_location(
        "gen_mini_seg_data", os.path.join(REPO, "scripts", "data_utils",
                                          "gen_mini_seg_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    gen = _gen()
    gen.gen_coco(str(root / "coco"), 4, 4, 48)
    gen.gen_voc(str(root / "voc"), 8, 48)
    return root


def _same_sample(mine, ref):
    assert set(mine) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(v),
                                      err_msg=k)


# ---- metrics ----------------------------------------------------------------

def _masks(seed=0, B=3, H=12, W=10):
    r = np.random.RandomState(seed)
    gt = r.randint(0, 4, (B, H, W))
    pred = r.randint(0, 5, (B, H, W))
    overlap = (r.rand(B, H, W) < 0.2).astype(np.int64)
    gt[0] = 0  # an image of background only
    return gt, pred, overlap


@pytest.mark.parametrize("name", ["ARI_metric", "fARI_metric", "miou_metric",
                                  "fmiou_metric", "mbo_metric"])
@pytest.mark.parametrize("with_overlap", [False, True])
def test_metrics_with_and_without_overlap_match_jax(name, with_overlap):
    gt, pred, overlap = _masks()
    ov = overlap if with_overlap else None
    want = getattr(JM, name)(gt, pred, ov)
    got = getattr(M, name)(torch.from_numpy(gt), torch.from_numpy(pred),
                           None if ov is None else torch.from_numpy(ov))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_preproc_masks_overlap_matches_jax():
    gt, pred, overlap = _masks(1)
    for i in range(gt.shape[0]):
        g, p = JM.preproc_masks_overlap(gt[i], pred[i], overlap[i])
        tg, tp = M.preproc_masks_overlap(gt[i], pred[i], overlap[i])
        np.testing.assert_array_equal(tg.numpy(), g)
        np.testing.assert_array_equal(tp.numpy(), p)
    g0, p0 = gt[0], pred[0]
    g, p = M.preproc_masks_overlap(g0, p0)
    assert g is g0 and p is p0


def test_seg_metrics_fn_dual_protocol_matches_jax():
    """Soft masks [B, N, H, W]: `inst/*` and `sem/*` with the overlap,
    and the plain five without instance masks."""
    gt, _, overlap = _masks(2)
    inst = np.random.RandomState(3).randint(0, 5, gt.shape)
    soft = np.random.RandomState(4).rand(3, 5, *gt.shape[1:]).astype(
        np.float32)
    batch = {"masks": gt, "inst_masks": inst, "overlap_masks": overlap}
    want = jax_seg_metrics(batch, {"masks": soft})
    got = seg_metrics_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                         {"masks": torch.from_numpy(soft)})
    assert set(got) == set(want) and len(want) == 10
    assert {k.split("/")[0] for k in want} == {"inst", "sem"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12, err_msg=k)
    plain = seg_metrics_fn({"masks": torch.from_numpy(gt)},
                           {"masks": torch.from_numpy(soft)})
    assert set(plain) == {"ari", "fari", "miou", "fmiou", "mbo"}


# ---- the COCO reader --------------------------------------------------------

def test_rle_and_polygons_match_jax():
    r = np.random.RandomState(5)
    for _ in range(5):
        m = r.rand(13, 9) < 0.4
        counts = api.mask_to_rle(m)
        assert counts == jax_api.mask_to_rle(m)
        s = api.encode_rle_string(counts)
        assert s == jax_api.encode_rle_string(counts)
        assert api.decode_rle_string(s) == counts
        np.testing.assert_array_equal(api.rle_to_mask(counts, (13, 9)), m)
    polys = [[1, 1, 10, 2, 6, 9], [12, 12, 15, 12, 15, 15, 12, 15]]
    np.testing.assert_array_equal(api.polygons_to_mask(polys, (16, 17)),
                                  jax_api.polygons_to_mask(polys, (16, 17)))


def test_minicoco_matches_jax(trees):
    path = str(trees / "coco" / "annotations" / "instances_val2017.json")
    mine, ref = api.MiniCOCO(path), jax_api.MiniCOCO(path)
    assert mine.getImgIds() == ref.getImgIds()
    assert mine.getCatIds() == ref.getCatIds()
    for img in ref.getImgIds():
        ids = ref.getAnnIds(imgIds=img)
        assert mine.getAnnIds(imgIds=img) == ids
        for a, b in zip(mine.loadAnns(ids), ref.loadAnns(ids)):
            np.testing.assert_array_equal(mine.annToMask(a),
                                          ref.annToMask(b))


# ---- datasets ---------------------------------------------------------------

@pytest.mark.parametrize("split", ["val", "train"])
def test_coco_dataset_and_collate_match_jax(trees, split):
    kw = dict(data_root=str(trees / "coco"), resolution=RES, split=split)
    mine, ref = COCODataset(**kw), JaxCOCO(**kw)
    assert len(mine) == len(ref) == 4
    for epoch in (0, 1) if split == "train" else (0,):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        samples = [mine[i] for i in range(4)]
        refs = [ref[i] for i in range(4)]
        for a, b in zip(samples, refs):
            _same_sample(a, b)
            assert a["img"].shape == (*RES, 3)
        batch = coco_collate_fn(samples)
        want = jax_collate([dict(s) for s in refs])
        assert all(isinstance(v, torch.Tensor) for v in batch.values())
        _same_sample({k: v.numpy() for k, v in batch.items()}, want)


@pytest.mark.parametrize("split", ["val", "trainaug"])
def test_voc_dataset_matches_jax(trees, split):
    kw = dict(data_root=str(trees / "voc"), resolution=RES, split=split)
    mine, ref = VOCDataset(**kw), JaxVOC(**kw)
    assert len(mine) == len(ref) > 0
    for i in range(len(ref)):
        _same_sample(mine[i], ref[i])
    assert ("inst_masks" in mine[0]) == (split == "val")


def test_synthetic_coco_matches_jax():
    for seed in (0, 1):
        mine = SyntheticCOCODataset(RES, 4, seed=seed)
        ref = JaxSynth(RES, 4, seed=seed)
        for i in range(4):
            _same_sample(mine[i], ref[i])


def test_datamodule_batches_coco_with_its_collater(trees):
    cfg = configs.SACOCOFile64().copy(
        data_root=str(trees / "coco"), resolution=RES, train_batch_size=2,
        val_batch_size=3, num_workers=0)
    assert collate_fn(cfg) is coco_collate_fn
    assert collate_fn(configs.SAVOCFile64()) is None
    data = build_datamodule(cfg)
    batch = next(iter(data.val_loader()))
    assert batch["annos"].shape[0] == 3 and batch["annos"].shape[2] == 5
    assert {"img", "masks", "inst_masks", "overlap_masks"} <= set(batch)
    assert len(list(data.train_loader(1))) == 2


# ---- configs ----------------------------------------------------------------

@pytest.mark.parametrize("name,path", [
    ("SALDMDINOCOCO224", "img_based/sa_ldm/sa_ldm_dino_coco_params-res224.py"),
    ("SALDMDINOVOC224", "img_based/sa_ldm/sa_ldm_dino_voc_params-res224.py"),
    ("VQVAECOCO224", "img_based/sa_ldm/vqvae_coco_params-res224.py"),
    ("VQVAEVOC224", "img_based/sa_ldm/vqvae_voc_params-res224.py"),
    ("SASynthetic64", "sa_synthetic_params-res64.py"),
    ("SACOCOFile64", "sa_coco_file-res64.py"),
    ("SAVOCFile64", "sa_voc_file-res64.py"),
    ("SASyntheticCOCO64", "sa_synthetic_coco-res64.py")])
def test_coco_voc_configs_match_the_jax_config_files(name, path):
    from slotdiffusion_tpu.utils import load_params
    ref = load_params(os.path.join(REPO, "configs", path))
    mine = configs.get_config(name)
    keys = [k for k in dir(mine) if not k.startswith("_") and
            not callable(getattr(mine, k)) and ref.has(k)]
    assert {"model", "lr", "train_batch_size", "dataset"} <= set(keys)
    _same_config({k: _plain(getattr(mine, k)) for k in keys},
                 {k: _plain(ref.get(k)) for k in keys}, name)


@pytest.mark.parametrize("name,slots,size", [("SALDMDINOCOCO224", 7, 256),
                                             ("SALDMDINOVOC224", 6, 192)])
def test_res224_configs_build_with_their_shapes(name, slots, size):
    from slotdiffusion_tpu_torch.models import build_model
    with torch.device("meta"):
        model = build_model(configs.get_config(name), device="meta")
    sd = model.state_dict()
    dino = "encoder.encoder.dino."
    assert sd[dino + "embeddings.position_embeddings"].shape == \
        (1, 28 * 28 + 1, 384)
    assert sd[dino + "embeddings.patch_embeddings.projection.weight"] \
        .shape == (384, 3, 8, 8)
    assert sum(k.startswith(dino + "encoder.layer.") and
               k.endswith("attention.attention.query.weight")
               for k in sd) == 12
    assert sd["encoder.encoder_pos_embedding.dense.weight"].shape == (384, 4)
    assert sd["encoder.encoder_out_layer.3.weight"].shape == (size, size)
    assert sd["init_latents"].shape == (1, slots, size)
    assert model.slot_attention.num_iterations == 3
    assert model.dm_decoder.resolution == (56, 56)
    assert model.frozen_modules == (model.encoder.encoder.dino,
                                    model.dm_decoder.vae)
    assert model.dm_decoder.unet.input_blocks[0][0].weight.shape[0] == 128
