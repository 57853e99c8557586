"""The port's epoch-end visualisation (`slotdiffusion_tpu_torch/methods/
viz.py`, `utils/vis.py`, `utils/png.py`, the trainer's hook) against the
JAX package's `methods/viz.py` and `utils/vis.py` on the CPU.

- the vis helpers equal the JAX ones bit for bit;
- the PNG / APNG writer: PIL decodes its files to the arrays written, and
  to what the JAX `save_image` file decodes to; the port's reader reads
  them back;
- the deterministic families (SA, SAVi, the VQ-VAE and dVAE recon pairs,
  SLATE's and STEVE's masks, SlotFormer's decoded rollout) draw PNGs
  pixel for pixel equal to the JAX callbacks' on the same batch and
  outputs; the clips (APNG here, mp4 / GIF there) hold the frames the JAX
  callbacks' grids are drawn from;
- the sampled families (SADiffusion with its denoise row, SAViDiffusion
  through the config's chain) draw grids of the expected sizes whose
  ground-truth rows equal the JAX package's;
- wandb mirroring through a stub module; the trainer's guard, `use_viz`
  and the checkpoint directory; and that no module of the port imports
  jax or the JAX package.
"""

import ast
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from slotdiffusion_tpu.methods import viz as jax_viz
from slotdiffusion_tpu.utils import vis as jax_vis
from slotdiffusion_tpu.utils.misc import save_image as jax_save_image
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.data.loader import DataModule
from slotdiffusion_tpu_torch.data.synthetic import SyntheticImageDataset
from slotdiffusion_tpu_torch.methods import viz
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.training.trainer import WandbLogger
from slotdiffusion_tpu_torch.utils import png, vis
from torch_parity_helpers import (RES, SLOTS, T_FRAMES, tiny_config,
                                  tiny_image_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pil(path):
    return np.asarray(Image.open(path))


def _soft_masks(r, *shape):
    m = r.rand(*shape).astype(np.float32)
    return m / m.sum(-4 if shape[-1] == 1 else -3, keepdims=True)


# ---- vis helpers and the PNG writer ----------------------------------------

def test_vis_helpers_match_jax():
    r = np.random.RandomState(0)
    for img in (r.uniform(-1, 1, (6, 7, 3)).astype(np.float32),
                r.uniform(0, 1, (6, 7, 3)).astype(np.float32),
                r.randint(0, 256, (6, 7, 3)).astype(np.uint8)):
        np.testing.assert_array_equal(vis._to_uint8(img),
                                      jax_vis._to_uint8(img))
        ids = r.randint(0, 25, (6, 7))
        np.testing.assert_array_equal(vis.draw_mask(img, ids),
                                      jax_vis.draw_mask(img, ids))
        rgb = r.uniform(0, 1, (6, 7, 3)).astype(np.float32)
        np.testing.assert_array_equal(vis.draw_rgb_mask(img, rgb, 0.3),
                                      jax_vis.draw_rgb_mask(img, rgb, 0.3))
    imgs = r.randint(0, 256, (5, 4, 3, 3)).astype(np.uint8)
    np.testing.assert_array_equal(vis.make_grid(imgs, ncol=2),
                                  jax_vis.make_grid(imgs, ncol=2))
    np.testing.assert_array_equal(vis.PALETTE, jax_vis.PALETTE)


@pytest.mark.parametrize("kind", ["uint8", "float", "grey", "rgba"])
def test_png_decodes_as_the_jax_file(tmp_path, kind):
    """PIL decodes the port's PNG to the array written (floats in [0, 1]
    as the JAX `save_image` converts them) and to the JAX file's pixels;
    the port's reader reads it back."""
    r = np.random.RandomState(1)
    shape = {"grey": (9, 11), "rgba": (9, 11, 4)}.get(kind, (9, 11, 3))
    img = r.rand(*shape).astype(np.float32) if kind == "float" else \
        r.randint(0, 256, shape).astype(np.uint8)
    path = png.save_image(img, str(tmp_path / "a.png"))
    want = png.to_uint8(img)
    np.testing.assert_array_equal(_pil(path), want)
    back, fps = png.read_png(path)
    assert fps is None
    np.testing.assert_array_equal(back[0], want.reshape(back.shape[1:]))
    if kind in ("uint8", "float"):
        jax_save_image(img, str(tmp_path / "j.png"))
        np.testing.assert_array_equal(_pil(path), _pil(tmp_path / "j.png"))


def test_apng_frames_decode_in_pil_and_back(tmp_path):
    """`save_video`: an `.apng` whose every frame PIL and the port's reader
    decode to the frames written, at the frame rate asked."""
    v = np.random.RandomState(2).randint(0, 256, (5, 6, 7, 3)).astype(
        np.uint8)
    path = png.save_video(v, str(tmp_path / "clip.mp4"), fps=4)
    assert path.endswith("clip.apng")
    im = Image.open(path)
    assert im.n_frames == 5 and im.is_animated
    for t in range(5):
        im.seek(t)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), v[t])
    back, fps = png.read_png(path)
    np.testing.assert_array_equal(back, v)
    assert fps == 4
    data = bytearray(open(path, "rb").read())
    data[40] ^= 1  # inside the first chunk after the signature
    with pytest.raises(ValueError):
        png.decode_png(bytes(data))


# ---- the deterministic families, pixel for pixel ---------------------------

def _both(tmp_path, fn_name, batch, out):
    """The JAX callback and the port's on the same batch and outputs ->
    (JAX viz dir, port viz dir)."""
    jd, pd = tmp_path / "jax", tmp_path / "port"
    getattr(jax_viz, fn_name)(types.SimpleNamespace(
        logger=types.SimpleNamespace()), batch, out, STEP, str(jd))
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    getattr(viz, fn_name)(types.SimpleNamespace(
        logger=types.SimpleNamespace()), to_t(batch), to_t(out), STEP,
        str(pd))
    return jd, pd


def _same_pngs(jd, pd, names):
    for n in names:
        np.testing.assert_array_equal(_pil(pd / n), _pil(jd / n), err_msg=n)


def test_sa_image_viz_matches_jax(tmp_path):
    r = np.random.RandomState(3)
    batch = {"img": r.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)}
    out = {"recon_img": r.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32),
           "recons": r.uniform(-1, 1, (3, 4, 8, 8, 3)).astype(np.float32),
           "masks": _soft_masks(r, 3, 4, 8, 8, 1)}
    jd, pd = _both(tmp_path, "viz_sa_image", batch, out)
    _same_pngs(jd, pd, [f"step{STEP}_recon.png", f"step{STEP}_slots.png"])
    assert sorted(os.listdir(pd)) == [f"step{STEP}_recon.png",
                                      f"step{STEP}_slots.png"]


def test_savi_video_viz_matches_jax(tmp_path):
    """The grid pixel for pixel; the overlay clip (APNG) holds the frames
    of the grid's overlay row."""
    r = np.random.RandomState(4)
    batch = {"img": r.uniform(-1, 1, (2, 3, 8, 8, 3)).astype(np.float32)}
    out = {"recon_img": r.uniform(-1, 1, (2, 3, 8, 8, 3)).astype(
        np.float32), "masks": _soft_masks(r, 2, 3, 4, 4, 4, 1)}
    jd, pd = _both(tmp_path, "viz_savi_video", batch, out)
    _same_pngs(jd, pd, [f"step{STEP}_video.png"])
    frames, fps = png.read_png(str(pd / f"step{STEP}_video_overlay.apng"))
    grid = _pil(jd / f"step{STEP}_video.png")
    assert fps == 8 and frames.shape == (3, 8, 8, 3)
    np.testing.assert_array_equal(np.concatenate(list(frames), axis=1),
                                  grid[-8:])


@pytest.mark.parametrize("video", [False, True])
def test_recon_pairs_viz_matches_jax(tmp_path, video):
    r = np.random.RandomState(5)
    shape = (2, 3, 8, 8, 3) if video else (5, 8, 8, 3)
    batch = {"img": r.uniform(-1, 1, shape).astype(np.float32)}
    out = {"recon": r.uniform(-1, 1, shape).astype(np.float32)}
    jd, pd = _both(tmp_path, "viz_recon_pairs", batch, out)
    _same_pngs(jd, pd, [f"step{STEP}_recon.png"])


@pytest.mark.parametrize("video,recon", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_slate_steve_viz_matches_jax(tmp_path, video, recon):
    """SLATE (images) and STEVE (clips): mask overlays at a coarser
    resolution than the images (nearest-resized), with and without the
    pixel loss's reconstruction."""
    r = np.random.RandomState(6)
    shape = (2, 3, 8, 8, 3) if video else (3, 8, 8, 3)
    batch = {"img": r.uniform(-1, 1, shape).astype(np.float32)}
    masks = _soft_masks(r, *shape[:-3], 4, 4, 4, 1)
    out = {"masks": masks}
    if recon:
        n = 6 if video else 3
        out["recon_img"] = r.uniform(-1, 1, (n, 8, 8, 3)).astype(np.float32)
    jd, pd = _both(tmp_path, "viz_slate", batch, out)
    _same_pngs(jd, pd, [f"step{STEP}_masks.png"])


def test_slotformer_viz_matches_jax(tmp_path):
    """SlotFormer with the spatial broadcast decoder: the decoded rollout
    of the first clip under its frames, pixel for pixel on the same
    seeded weights; the rollout clip holds the grid's lower row. Without
    a decoder nothing is drawn."""
    from test_torch_slotformer import (_jax_params, _slotformer_config,
                                       _slotformer_pair, _slots)
    cfg = _slotformer_config(img_recon=True)
    jm, jv, port = _slotformer_pair(cfg)
    slots = _slots(1)
    imgs = np.random.RandomState(7).uniform(
        -1, 1, (*slots.shape[:2], *RES, 3)).astype(np.float32)
    jp = _jax_params(cfg)
    jtrainer = types.SimpleNamespace(
        model=jm, params=jp, logger=types.SimpleNamespace(),
        state=types.SimpleNamespace(params=jv["params"]))
    jax_viz.viz_slotformer(jtrainer, {"slots": slots, "img": imgs}, {}, STEP,
                           str(tmp_path / "jax"))
    trainer = types.SimpleNamespace(model=port.eval(), params=cfg,
                                    device=torch.device("cpu"),
                                    logger=types.SimpleNamespace())
    viz.viz_slotformer(trainer, {"slots": torch.from_numpy(slots),
                                 "img": torch.from_numpy(imgs)}, {}, STEP,
                       str(tmp_path / "port"))
    _same_pngs(tmp_path / "jax", tmp_path / "port",
               [f"step{STEP}_rollout.png"])
    frames, _ = png.read_png(str(tmp_path / "port" /
                                 f"step{STEP}_rollout.apng"))
    grid = _pil(tmp_path / "port" / f"step{STEP}_rollout.png")
    np.testing.assert_array_equal(np.concatenate(list(frames), axis=1),
                                  grid[-RES[0]:])
    trainer.params = cfg.copy(dec_dict={})
    viz.viz_slotformer(trainer, {"slots": torch.from_numpy(slots)}, {},
                       STEP, str(tmp_path / "none"))
    assert not os.path.exists(tmp_path / "none")


# ---- the sampled families -------------------------------------------------

def _gt_row(img):
    return jax_viz._frames_strip(np.stack([jax_viz._u8(im) for im in img]))


def test_diffusion_image_viz_draws_samples_and_the_denoise_row(tmp_path):
    """SADiffusion (tiny, seeded): 4 images, their DDIM samples and mask
    overlays as rows (the first row equal to the JAX package's), and the
    first image's trajectory (x_T, then every `log_every_t`-th step)."""
    cfg = tiny_image_config("SADiffusion")
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu").eval()
    img = np.random.RandomState(8).uniform(-1, 1, (5, *RES, 3)).astype(
        np.float32)
    trainer = types.SimpleNamespace(model=model, params=cfg,
                                    device=torch.device("cpu"),
                                    logger=types.SimpleNamespace())
    viz.build_viz_fn(cfg)(trainer, {"img": torch.from_numpy(img)}, {}, STEP,
                          str(tmp_path))
    grid = _pil(tmp_path / f"step{STEP}_samples.png")
    H, W = RES
    assert grid.shape == (3 * H + 4, 4 * W, 3)
    np.testing.assert_array_equal(grid[:H], _gt_row(img[:4]))
    row = _pil(tmp_path / f"step{STEP}_denoise_row.png")
    assert row.shape[0] == H and row.shape[1] % W == 0 and \
        row.shape[1] // W >= 2


def test_diffusion_video_viz_takes_the_configs_chain(tmp_path):
    """SAViDiffusion (the tiny flagship, `use_dpm` False as the flagship's):
    the ancestral chain over all its timesteps (one UNet call each), the
    first video's frames, samples and overlays as rows, and its samples
    as a clip; with `use_dpm` True, DPM-Solver++'s 20 calls."""
    cfg = tiny_config()
    assert cfg.use_dpm is False
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu").eval()
    calls = []
    model.dm_decoder.unet.register_forward_hook(
        lambda *a: calls.append(1))
    img = np.random.RandomState(9).uniform(
        -1, 1, (3, T_FRAMES, *RES, 3)).astype(np.float32)
    trainer = types.SimpleNamespace(model=model, params=cfg,
                                    device=torch.device("cpu"),
                                    logger=types.SimpleNamespace())
    viz.build_viz_fn(cfg)(trainer, {"img": torch.from_numpy(img)}, {}, STEP,
                          str(tmp_path))
    assert len(calls) == model.dm_decoder.num_timesteps
    H, W = RES
    grid = _pil(tmp_path / f"step{STEP}_video_samples.png")
    assert grid.shape == (3 * H + 4, T_FRAMES * W, 3)
    np.testing.assert_array_equal(grid[:H], _gt_row(img[0]))
    frames, _ = png.read_png(str(tmp_path / f"step{STEP}_video_samples.apng"))
    np.testing.assert_array_equal(np.concatenate(list(frames), axis=1),
                                  grid[H + 2:2 * H + 2])
    calls.clear()
    trainer.params = cfg.copy(use_dpm=True)
    viz.build_viz_fn(cfg)(trainer, {"img": torch.from_numpy(img)}, {},
                          STEP + 1, str(tmp_path))
    assert len(calls) == model.dm_decoder.dpm_steps


def test_viz_families_match_jax():
    assert set(viz.VIZ_FNS) == set(jax_viz._VIZ_FNS)
    for name, fn in viz.VIZ_FNS.items():
        assert fn.__name__ == jax_viz._VIZ_FNS[name].__name__, name
    assert viz.build_viz_fn(configs.ReadoutSynthetic()) is None


# ---- wandb, the trainer's hook ----------------------------------------------

class _StubWandb(types.ModuleType):
    """A wandb lookalike recording each call."""

    def __init__(self):
        super().__init__("wandb")
        self.logged = []

    def init(self, **kwargs):
        self.init_kwargs = kwargs

    def log(self, record, step=None):
        self.logged.append((record, step))

    class Image:
        def __init__(self, path):
            self.path = path

    class Video:
        def __init__(self, data, fps=None):
            self.data, self.fps = data, fps


def test_save_mirrors_media_to_wandb(tmp_path, monkeypatch):
    """`_save` through a `WandbLogger`: a PNG as `wandb.Image(path)`, a clip
    as `wandb.Video` of its frames [T, C, H, W] at its fps, both under
    `viz/<tag>` at the step; the scalar records go on through the same
    run."""
    stub = _StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    logger = WandbLogger(str(tmp_path), project="p")
    trainer = types.SimpleNamespace(logger=logger)
    img = np.random.RandomState(0).randint(0, 255, (6, 9, 3)).astype(np.uint8)
    path = viz._save(trainer, "recon", img, 7, str(tmp_path / "v"))
    clip = np.random.RandomState(1).randint(0, 255, (4, 5, 5, 3)).astype(
        np.uint8)
    vpath = viz._save(trainer, "rollout", clip, 7, str(tmp_path / "v"),
                      fps=4)
    media = {k: (v, s) for rec, s in stub.logged for k, v in rec.items()}
    assert media["viz/recon"][0].path == path and media["viz/recon"][1] == 7
    video, step = media["viz/rollout"]
    assert step == 7 and video.fps == 4 and vpath.endswith(".apng")
    np.testing.assert_array_equal(video.data, clip.transpose(0, 3, 1, 2))
    logger.log({"val/loss": 0.5}, step=7)
    assert any("val/loss" in rec for rec, _ in stub.logged)


@pytest.fixture
def sa_trainer_parts():
    cfg = tiny_image_config("SA").copy(num_workers=0)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    data = DataModule(SyntheticImageDataset(RES, 2, seed=0),
                      SyntheticImageDataset(RES, 4, seed=1), 2, 2, seed=0)
    return cfg, model, data


def test_validate_draws_the_first_batch(sa_trainer_parts, tmp_path):
    """`build_method` wires the family's callback; `validate` with a
    checkpoint directory calls it once after logging, with the first val
    batch, its outputs, the step and `<ckp_path>/viz`; the PNGs land
    there."""
    cfg, model, data = sa_trainer_parts
    trainer = build_method(model, data, cfg, ckp_path=str(tmp_path))
    assert trainer.viz_fn is viz.viz_sa_image
    seen = []
    trainer.viz_fn = lambda *a: seen.append(a) or viz.viz_sa_image(*a)
    res = trainer.validate()
    assert res and len(seen) == 1
    t, batch, out, step, viz_dir = seen[0]
    assert t is trainer and step == 0 and batch["img"].shape == (2, *RES, 3)
    assert torch.equal(batch["img"], next(iter(data.val_loader()))["img"])
    assert out["recon_img"].shape == (2, *RES, 3)
    assert viz_dir == os.path.join(str(tmp_path), "viz")
    assert sorted(os.listdir(viz_dir)) == ["step0_recon.png",
                                           "step0_slots.png"]


def test_viz_guard_use_viz_and_no_checkpoint_dir(sa_trainer_parts, tmp_path,
                                                 capsys):
    """A callback that raises is printed and validation goes on (the JAX
    trainer's guard); `use_viz=False` or no checkpoint directory: no
    call."""
    cfg, model, data = sa_trainer_parts
    calls = []

    def boom(*a):
        calls.append(a)
        raise RuntimeError("boom")

    trainer = build_method(model, data, cfg, ckp_path=str(tmp_path))
    trainer.viz_fn = boom
    res = trainer.validate()
    assert "val/img_recon_loss" in res and len(calls) == 1
    assert "[viz] skipped: RuntimeError: boom" in capsys.readouterr().out
    for tr in (build_method(model, data, cfg.copy(use_viz=False),
                            ckp_path=str(tmp_path)),
               build_method(model, data, cfg)):
        tr.viz_fn = boom
        assert tr.validate()
    assert len(calls) == 1


# ---- the port imports neither jax nor the JAX package -----------------------

def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "scripts", f) for f in os.listdir(
        os.path.join(REPO, "scripts")) if f.endswith("_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "slotdiffusion_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_port_module_imports_jax_or_the_jax_package():
    """Every import statement of the port's package, its scripts
    (`scripts/*_torch.py`) and `chip_smoke.py` names neither jax, flax,
    orbax nor `slotdiffusion_tpu` (the port's own package aside)."""
    files = _port_files()
    assert len(files) > 60
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            names = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) and not node.level else []
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "flax", "orbax", "slotdiffusion_tpu",
                           "jaxlib"):
                    bad.append((os.path.relpath(path, REPO), n))
    assert not bad, bad
    assert jax.__name__ == "jax"  # the test itself runs beside JAX
