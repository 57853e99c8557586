"""The port's checkpoint format (the counterpart of the JAX package's
training/checkpoint.py and the orbax saves of its trainer.py:339-447).

A checkpoint is one `torch.save` file of a dict: `model` (state_dict),
`optimizer`, `step` (micro-steps taken), `ema` (or None) and `generator`
(the run's torch.Generator state). `ckpt_last` is written crash-safe: the
file goes to a temporary name in the same directory and `os.replace`
swaps it in, so a crash at any instant leaves the old or the new file
whole. Orbax checkpoints of the JAX package are not read (the card machine
has no orbax); `graft_pretrained` grafts a frozen VQ-VAE from a
port-format file, the counterpart of the JAX package's `apply_pretrained`.
"""

import os
import tempfile

import torch


def save_checkpoint(path, state):
    """Write `state` to `path` atomically."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-" +
                               os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_checkpoint(path, map_location="cpu"):
    # the file holds tensors and plain containers only
    return torch.load(path, map_location=map_location, weights_only=True)


def graft_pretrained(model, cfg):
    """Copy the frozen VQ-VAE named by `cfg.dec_dict["vae_dict"]
    ["vqvae_ckp_path"]` into `model.dm_decoder.vae.vqvae`. The file is a
    port-format checkpoint whose `model` holds the VQ-VAE's entries,
    relative to the VQ-VAE module or prefixed `dm_decoder.vae.vqvae.` (a
    SAViDiffusion checkpoint). Every parameter must be present with its
    shape. A config without the path leaves the model as it is; returns
    whether it grafted."""
    vae = (getattr(cfg, "dec_dict", None) or {}).get("vae_dict") or {}
    path = vae.get("vqvae_ckp_path")
    if not path:
        return False
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"pretrained VQ-VAE {path!r} not found: train the stage-1 model "
            "first or clear vqvae_ckp_path")
    src = load_checkpoint(path)["model"]
    prefix = "dm_decoder.vae.vqvae."
    src = {k[len(prefix):] if k.startswith(prefix) else k: v
           for k, v in src.items()}
    dst = model.dm_decoder.vae.vqvae
    want = dst.state_dict()
    missing = sorted(set(want) - set(src))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} VQ-VAE entries: "
                       f"{missing[:5]}")
    for k, v in want.items():
        if src[k].shape != v.shape:
            raise ValueError(f"{path}: {k} has shape {tuple(src[k].shape)},"
                             f" the model {tuple(v.shape)}")
    dst.load_state_dict({k: src[k] for k in want})
    return True
