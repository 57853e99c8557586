"""The epoch-end visualisation of the port (an own copy of the JAX
package's methods/viz.py): after a `Trainer.validate` with a checkpoint
directory, the family's callback draws the first val batch and its
outputs into PNG grids (and APNG clips, where the JAX package writes
mp4) under `<ckp_path>/viz/`, mirrored to wandb when the trainer logs
there (`wandb.Image` of the file; `wandb.Video` of the frames, since
wandb takes no APNG).

Callbacks take (trainer, batch, out, step, viz_dir): the batch as the
loader gave it, the live pass's outputs of `eval_step`. The image
assembly is numpy on the host; the generative families sample on the
model's device (under `no_grad`) from a generator seeded with the step:
SADiffusion through `log_images` with its DDIM denoise row
(`viz_denoise_rows`), SAViDiffusion with one noise sample shared over the
frames, both by DPM-Solver++ or, where the config's `use_dpm` is False
(the MOVi flagship), the ancestral chain; SlotFormer and LDMSlotFormer
decode their rollout.
"""

import os

import numpy as np
import torch

from ..utils import vis
from ..utils.png import save_image, save_video


def _np(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x)


def _u8(img):
    """[-1, 1] / [0, 1] floats or uint8 [H, W, 3] -> uint8."""
    return vis._to_uint8(_np(img))


def _resize_ids(ids, out_hw):
    """Nearest resize of an integer id map [h, w] -> [H, W]."""
    h, w = ids.shape
    H, W = out_hw
    return ids[(np.arange(H) * h) // H][:, (np.arange(W) * w) // W]


def _overlay(img, soft_masks):
    """img [H, W, 3]; soft masks [N, h, w(, 1)] -> the argmax slot's
    colour over the image, uint8."""
    m = _np(soft_masks)
    if m.ndim == 4 and m.shape[-1] == 1:
        m = m[..., 0]
    ids = m.argmax(axis=0)
    if ids.shape != img.shape[:2]:
        ids = _resize_ids(ids, img.shape[:2])
    return vis.draw_mask(img, ids)


def _save(trainer, tag, img, step, viz_dir, fps=None):
    """One PNG (an APNG of frames [T, H, W, 3] when `fps` is given) as
    `step{step}_{tag}`, mirrored to wandb. -> the path written."""
    img = np.asarray(img).astype(np.uint8)
    base = os.path.join(viz_dir, f"step{step}_{tag}")
    if fps is not None:
        path = save_video(img, base + ".apng", fps=fps)
    else:
        path = save_image(img, base + ".png")
    wandb = getattr(trainer.logger, "wandb", None)
    if wandb is not None:
        media = wandb.Video(img.transpose(0, 3, 1, 2), fps=fps) \
            if fps is not None else wandb.Image(path)
        wandb.log({f"viz/{tag}": media}, step=int(step))
    return path


def _strip(frames):
    """[T, H, W, 3] uint8 -> one [H, T*W, 3] row."""
    return np.concatenate(list(frames), axis=1)


def _row(imgs):
    return _strip(np.stack([_u8(im) for im in imgs]))


def _stack_rows(rows, pad=2):
    """Rows [H, W, 3] uint8 stacked with `pad` white lines between them,
    narrower rows padded white on the right."""
    W = max(r.shape[1] for r in rows)
    padded = []
    for r in rows:
        if r.shape[1] < W:
            r = np.pad(r, ((0, 0), (0, W - r.shape[1]), (0, 0)),
                       constant_values=255)
        padded += [r, np.full((pad, W, 3), 255, np.uint8)]
    return np.concatenate(padded[:-1], axis=0)


def _sample_generator(trainer, step):
    return torch.Generator(device=trainer.device).manual_seed(int(step))


# ---- per-family callbacks --------------------------------------------------

def viz_sa_image(trainer, batch, out, step, viz_dir, n=8):
    """SA: rows of the images, their reconstructions and mask overlays,
    and the first image's per-slot RGB."""
    img = _np(batch["img"][:n])
    rows = [_row(img)]
    if "recon_img" in out:
        rows.append(_row(_np(out["recon_img"][:n])))
    if "masks" in out:
        masks = _np(out["masks"][:n])
        rows.append(_strip(np.stack([_overlay(img[b], masks[b])
                                     for b in range(img.shape[0])])))
    _save(trainer, "recon", _stack_rows(rows), step, viz_dir)
    if "recons" in out:
        _save(trainer, "slots", _row(_np(out["recons"][0])), step, viz_dir)


def viz_savi_video(trainer, batch, out, step, viz_dir):
    """SAVi: the first video's frames, reconstruction and mask overlays as
    rows, and the overlays as a clip."""
    img = _np(batch["img"][0])
    rows = [_row(img)]
    if "recon_img" in out:
        rows.append(_row(_np(out["recon_img"][0])))
    overlay = None
    if "masks" in out:
        masks = _np(out["masks"][0])
        overlay = np.stack([_overlay(img[t], masks[t])
                            for t in range(img.shape[0])])
        rows.append(_strip(overlay))
    _save(trainer, "video", _stack_rows(rows), step, viz_dir)
    if overlay is not None:
        _save(trainer, "video_overlay", overlay, step, viz_dir, fps=8)


@torch.no_grad()
def viz_diffusion_image(trainer, batch, out, step, viz_dir, n=4):
    """SADiffusion: `n` images, their samples (the config's sampler; a
    fresh noise sample each, `same_noise` False by default) and mask
    overlays; with `viz_denoise_rows` the samples come from DDIM and the
    first image's trajectory is a row of its own."""
    params, model = trainer.params, trainer.model
    denoise_row = getattr(params, "viz_denoise_rows", True)
    img_t = batch["img"][:n].to(trainer.device)
    res = model.log_images(
        {"img": img_t}, _sample_generator(trainer, step),
        use_dpm=getattr(params, "use_dpm", True),
        same_noise=getattr(params, "same_noise", False),
        ret_intermed=denoise_row)
    img = _np(batch["img"][:n])
    masks = _np(res["masks"])
    rows = [_row(img), _row(_np(res["samples"])),
            _strip(np.stack([_overlay(img[b], masks[b])
                             for b in range(img.shape[0])]))]
    _save(trainer, "samples", _stack_rows(rows), step, viz_dir)
    if res.get("intermed") is not None:
        # [K, B, H, W, 3]: the first image at each logged step
        _save(trainer, "denoise_row", _row(_np(res["intermed"][:, 0])),
              step, viz_dir)


@torch.no_grad()
def viz_diffusion_video(trainer, batch, out, step, viz_dir, n=2):
    """SAViDiffusion: `n` videos sampled with one noise sample shared by
    the frames (the config's sampler); the first one's frames, samples
    and mask overlays as rows, and its samples as a clip."""
    params, model = trainer.params, trainer.model
    res = model.log_images(
        {"img": batch["img"][:n].to(trainer.device)},
        _sample_generator(trainer, step),
        use_dpm=getattr(params, "use_dpm", True),
        same_noise=getattr(params, "same_noise", True))
    img = _np(batch["img"][0])
    samples, masks = _np(res["samples"][0]), _np(res["masks"][0])
    rows = [_row(img), _row(samples),
            _strip(np.stack([_overlay(img[t], masks[t])
                             for t in range(img.shape[0])]))]
    _save(trainer, "video_samples", _stack_rows(rows), step, viz_dir)
    _save(trainer, "video_samples", np.stack([_u8(f) for f in samples]),
          step, viz_dir, fps=8)


def viz_slate(trainer, batch, out, step, viz_dir):
    """SLATE / STEVE: mask overlays (and the soft reconstruction, when the
    pixel loss gives one); no AR generation during training."""
    img = _np(batch["img"])
    if img.ndim == 5:  # the first video, frames as columns
        img0, masks = img[0], _np(out["masks"][0])
        rows = [_row(img0), _strip(np.stack([
            _overlay(img0[t], masks[t]) for t in range(img0.shape[0])]))]
        if "recon_img" in out:
            rows.insert(1, _row(_np(out["recon_img"]).reshape(img.shape)[0]))
    else:
        n = min(8, img.shape[0])
        masks = _np(out["masks"][:n])
        rows = [_row(img[:n]), _strip(np.stack([
            _overlay(img[b], masks[b]) for b in range(n)]))]
        if "recon_img" in out:
            rows.insert(1, _row(_np(out["recon_img"][:n])))
    _save(trainer, "masks", _stack_rows(rows), step, viz_dir)


def viz_recon_pairs(trainer, batch, out, step, viz_dir, n=8,
                    recon_key="recon"):
    """VQ-VAE / dVAE: rows of `n` frames and their reconstructions."""
    img, rec = _np(batch["img"]), _np(out[recon_key])
    if img.ndim == 5:
        img = img.reshape(-1, *img.shape[2:])
    if rec.ndim == 5:
        rec = rec.reshape(-1, *rec.shape[2:])
    n = min(n, img.shape[0], rec.shape[0])
    _save(trainer, "recon", _stack_rows([_row(img[:n]), _row(rec[:n])]),
          step, viz_dir)


@torch.no_grad()
def viz_slotformer(trainer, batch, out, step, viz_dir, n=1):
    """SlotFormer / LDMSlotFormer: the first clip's observed and rolled-out
    slots decoded (under the ground-truth frames when the batch has them),
    as a grid and a clip; nothing without a decoder."""
    params, model = trainer.params, trainer.model
    if not getattr(params, "dec_dict", None):
        return
    slots = batch["slots"][:n].to(trainer.device)
    history = model.history_len
    kw = {"generator": _sample_generator(trainer, step)} \
        if params.model == "LDMSlotFormer" else {}
    res = model.rollout(slots[:, :history], slots.shape[1] - history,
                        decode=True, with_gt=True, **kw)
    pred = np.stack([_u8(f) for f in _np(res["recon_combined"][0])])
    rows = []
    if "img" in batch:
        rows.append(_row(_np(batch["img"][0][:pred.shape[0]])))
    rows.append(_strip(pred))
    _save(trainer, "rollout", _stack_rows(rows), step, viz_dir)
    _save(trainer, "rollout", pred, step, viz_dir, fps=8)


VIZ_FNS = {
    "SA": viz_sa_image,
    "SAVi": viz_savi_video,
    "SADiffusion": viz_diffusion_image,
    "SAViDiffusion": viz_diffusion_video,
    "SLATE": viz_slate,
    "STEVE": viz_slate,
    "VQVAE": viz_recon_pairs,
    "dVAE": viz_recon_pairs,
    "DVAE": viz_recon_pairs,
    "SlotFormer": viz_slotformer,
    "LDMSlotFormer": viz_slotformer,
}


def build_viz_fn(params):
    """The epoch-end callback of `params.model`, or None (the readout)."""
    return VIZ_FNS.get(params.model)
