"""The datasets of the video-prediction and VQA stage against the JAX
package's, on the CPU: every sample equal bit for bit (the same keys,
dtypes and values), built through each package's `build_dataset` from
one config:

- `synthetic_slots` with and without labels;
- `synthetic_video_slots` on the repo's extraction pickle
  (`checkpoint/savi_ldm_synthetic_long3-res64/slots_synthetic.pkl`), with
  the re-rendered videos;
- `synthetic_rollout_slots` on the repo's rollout pickle
  (`checkpoint/ldmslotformer_synthetic_long3-res64/rollout_slots_big.pkl`),
  its `_meta.max_objects` check;
- Physion on a tiny tree made here (frame folders, split JSONs, label
  CSVs, a bad-stimuli list): the videos' clips (train at every start,
  val strided with the frame-offset interleave) and whole videos, the
  slot clips (`frame_offset` 3), the readout and test label datasets
  (the `_img` and `-redyellow` keys, the bad stimuli dropped), the task
  bookkeeping, the split JSON looked up under `splits/Physion/`.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from slotdiffusion_tpu.data.builders import build_dataset as jax_build
from slotdiffusion_tpu.utils import BaseParams
from slotdiffusion_tpu.utils.misc import dump_obj
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.data import build_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_sample(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _jax_params(cfg):
    """The port config's settings as the JAX package's BaseParams."""
    p = BaseParams()
    for k in dir(cfg):
        if not k.startswith("_") and not callable(getattr(cfg, k)):
            setattr(p, k, getattr(cfg, k))
    return p


def _same_sets(cfg, idx=None, val_only=False):
    """Both packages' sets for `cfg`: the same lengths and samples (at
    `idx`, default all, of each)."""
    ours = build_dataset(cfg, val_only=val_only)
    theirs = jax_build(_jax_params(cfg), val_only=val_only)
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for i in (range(len(a)) if idx is None else idx):
            _same_sample(a[i], b[i])
    return ours


@pytest.mark.parametrize("name", ["SlotFormerSynthetic", "ReadoutSynthetic"])
def test_synthetic_slots_equal_jax(name):
    ours = _same_sets(configs.get_config(name), idx=(0, 1, 7, 31))
    assert ("label" in ours[0][0]) == (name == "ReadoutSynthetic")


def test_synthetic_video_slots_equal_jax():
    """Slots of the extraction pickle with the re-rendered 8-frame
    videos; `data_idx` is the source video's index."""
    cfg = configs.LDMSlotFormerSynthetic64Long3().copy(
        slots_root=os.path.join(REPO, configs.LDMSlotFormerSynthetic64Long3
                                .slots_root), load_img=True)
    train, val = _same_sets(cfg, idx=(0, 3, 31))
    s = val[3]
    assert s["img"].shape == (8, 64, 64, 3) and s["slots"].shape == (8, 6, 64)
    assert int(s["data_idx"]) == int(sorted(val.names, key=int)[3])
    assert len(train) == 512 and len(val) == 32


def test_synthetic_rollout_slots_equal_jax():
    """The rollout pickle's splits with the renderer's labels; a pickle
    rendered with another max_objects is refused."""
    root = os.path.join(REPO, configs.ReadoutSyntheticRolloutLong
                        .rollout_root)
    cfg = configs.ReadoutSyntheticRolloutLong().copy(rollout_root=root)
    train, val = _same_sets(cfg, idx=(0, 5, 255))
    test = _same_sets(cfg, idx=(0, 100), val_only=True)[0]
    assert (len(train), len(val), len(test)) == (512, 256, 256)
    assert {int(val[i]["task_idx"]) for i in range(len(val))} == \
        {0, 1, 2, 3}
    with pytest.raises(ValueError, match="max_objects"):
        build_dataset(cfg.copy(max_objects=5))


# ---- Physion on a tiny tree ------------------------------------------------

TASKS = ("Collide", "Drop")
VIDEO_LEN = 12


def _make_physion(root, subsets=("training", "readout")):
    """Frame folders `<task>_vid<v>_img` (and two test folders with
    `-redyellow`), the split JSONs (test's under splits/Physion/), the
    readout and test label CSVs and a bad-stimuli list; -> the folder
    names of each subset."""
    r = np.random.RandomState(0)
    names = {}
    for task in TASKS:
        names[task] = [f"{task.lower()}_vid{v}_img.mp4" for v in range(2)]
    test = {task: [f"{task.lower()}_test{v}-redyellow.mp4"
                   for v in range(2)] for task in TASKS}
    for stem in [n[:-4] for d in (names, test) for v in d.values()
                 for n in v]:
        os.makedirs(root / stem)
        for t in range(VIDEO_LEN):
            Image.fromarray((r.rand(20, 24, 3) * 255).astype(np.uint8)).save(
                root / stem / f"{t:06d}.jpg")
    os.makedirs(root / "splits" / "Physion")
    for subset in subsets:
        for split in ("train", "val"):
            with open(root / "splits" / f"{subset}_{split}.json", "w") as f:
                json.dump(names, f)
    with open(root / "splits" / "Physion" / "test_test.json", "w") as f:
        json.dump(test, f)
    (root / "splits" / "bad_stimuli.txt").write_text("drop_test1\n")
    os.makedirs(root / "PhysionTrainMP4s")
    os.makedirs(root / "PhysionTestMP4s")
    rows = [",ground truth outcome"] + [
        f"{n[:-8]},{['True', 'False'][i % 2]}"
        for i, n in enumerate(sum(names.values(), []))]
    (root / "PhysionTrainMP4s" / "readout_labels.csv").write_text(
        "\n".join(rows))
    rows = [",ground truth outcome"] + [
        f"{n.replace('-redyellow.mp4', '')},{['1', 'no'][i % 2]}"
        for i, n in enumerate(sum(test.values(), []))]
    (root / "PhysionTestMP4s" / "labels.csv").write_text("\n".join(rows))
    return names, test


@pytest.fixture(scope="module")
def physion(tmp_path_factory):
    root = tmp_path_factory.mktemp("physion")
    names, test = _make_physion(root)
    r = np.random.RandomState(1)
    stems = [n[:-4] for d in (names, test) for v in d.values() for n in v]
    slots = {s: r.randn(VIDEO_LEN, 3, 8).astype(np.float32) for s in stems}
    pkl = str(root / "slots.pkl")
    dump_obj({"train": slots, "val": slots, "test": slots}, pkl)
    return str(root), pkl


def _physion_cfg(root, base, **kw):
    return base().copy(data_root=root, resolution=(16, 16),
                       video_len=VIDEO_LEN, **kw)


def test_physion_videos_equal_jax(physion):
    """Clips of 3 frames 2 apart: train at every start with room (8 a
    video), val strided by 6 with the offset interleave (starts 0, 1, 6,
    7); whole videos of every 2nd frame."""
    root, _ = physion
    cfg = _physion_cfg(root, configs.SAViLDMPhysion128, n_sample_frames=3,
                       frame_offset=2)
    train, val = _same_sets(cfg, idx=(0, 7, 9, 15))
    assert (len(train), len(val)) == (4 * 8, 4 * 4)
    assert sorted({s for _, s in val.valid_idx}) == [0, 1, 6, 7]
    assert train.task2num == {"Collide": 2, "Drop": 2}
    assert set(train.video_idx2task_idx.values()) == {0, 1}
    theirs = jax_build(_jax_params(cfg), val_only=True)
    val.load_video = theirs.load_video = True
    assert len(val) == 4
    _same_sample(val[2], theirs[2])
    assert val[2]["video"].shape == (VIDEO_LEN // 2, 16, 16, 3)


def test_physion_slot_clips_equal_jax(physion):
    """`physion_slots_training` with frame_offset 3: slot clips read by
    the offset, and with `load_img` the clip's frames."""
    root, pkl = physion
    cfg = _physion_cfg(root, configs.LDMSlotFormerPhysion128,
                       slots_root=pkl, n_sample_frames=3, frame_offset=3,
                       load_img=True)
    train, val = _same_sets(cfg, idx=(0, 5, 11))
    folder, start = train.valid_idx[5]
    np.testing.assert_array_equal(
        train[5]["slots"],
        train.video_slots[os.path.basename(folder)][start:start + 7:3])


@pytest.mark.parametrize("subset", ["readout", "test"])
def test_physion_labels_equal_jax(physion, subset):
    """One (whole-video slots, label) pair a video: readout labels by the
    key without `_img`, test labels by the key without `-redyellow`, the
    bad stimulus dropped from test; `task_idx` per video."""
    root, pkl = physion
    dataset = f"physion_slots_label_{subset}"
    cfg = _physion_cfg(root, configs.ReadoutPhysion, slots_root=pkl,
                       dataset=dataset)
    sets = _same_sets(cfg, val_only=subset == "test")
    labels = [int(s["label"]) for s in sets[0]]
    if subset == "readout":
        assert len(sets) == 2 and labels == [1, 0, 1, 0]
    else:
        assert len(sets[0]) == 3  # drop_test1 is a bad stimulus
        assert all(s["slots"].shape == (VIDEO_LEN, 3, 8) for s in sets[0])
    assert sets[0][0]["task_idx"].dtype == np.int32
