"""The port's checkpoint format (the counterpart of the JAX package's
training/checkpoint.py and the orbax saves of its trainer.py:339-447).

A checkpoint is one `torch.save` file of a dict: `model` (state_dict),
`optimizer`, `step` (micro-steps taken), `ema` (or None) and `generator`
(the run's torch.Generator state). `ckpt_last` is written crash-safe: the
file goes to a temporary name in the same directory and `os.replace`
swaps it in, so a crash at any instant leaves the old or the new file
whole. Orbax checkpoints of the JAX package are not read (the card machine
has no orbax); `graft_pretrained` grafts a frozen VQ-VAE, diffusion
decoder or dVAE from a port-format file, the counterpart of the JAX
package's `apply_pretrained`.
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


def load_model_weights(model, path):
    """Load the model of a port-format file into `model`, strictly: a
    trainer's `ckpt_last.pt` (its EMA shadow, if any, swapped into
    `dm_decoder`, as the JAX package's `load_model_params` does) or a file
    of `scripts/export_torch_checkpoint.py` (converted with or without the
    EMA already). -> the file's dict."""
    state = load_checkpoint(path)
    sd = dict(state["model"])
    if isinstance(state.get("ema"), dict):
        sd.update(state["ema"]["shadow"])
    model.load_state_dict(sd, strict=True)
    return state


def _graft(path, dst, prefix, what, raw=False):
    """Load the entries of `dst` from the port-format file `path`, whose
    `model` holds them relative to `dst` or under `prefix` (a whole
    model's checkpoint): every entry present, each with its shape. A
    trainer's file keeps its EMA apart, so `model` is the raw parameters;
    with `raw`, an exported file whose `model` has the EMA swapped in is
    refused."""
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"pretrained {what} {path!r} not found: train the stage-1 model "
            "first or clear its checkpoint path")
    state = load_checkpoint(path)
    if raw and state.get("ema") is True:
        raise ValueError(f"{path} holds the EMA of the {what}, not its raw "
                         "parameters: export it with --no_ema")
    src = state["model"]
    src = {k[len(prefix):] if k.startswith(prefix) else k: v
           for k, v in src.items()}
    want = dst.state_dict()
    missing = sorted(set(want) - set(src))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} {what} entries: "
                       f"{missing[:5]}")
    for k, v in want.items():
        if src[k].shape != v.shape:
            raise ValueError(f"{path}: {k} has shape {tuple(src[k].shape)},"
                             f" the model {tuple(v.shape)}")
    dst.load_state_dict({k: src[k] for k in want})


def graft_pretrained(model, cfg):
    """Copy the frozen stage-1 models a config names into `model`: the
    VQ-VAE of `cfg.dec_dict["vae_dict"]["vqvae_ckp_path"]` into
    `model.dm_decoder.vae.vqvae` (its entries relative to the VQ-VAE or
    prefixed `dm_decoder.vae.vqvae.`, a SAViDiffusion checkpoint), then
    the whole diffusion decoder of `cfg.dec_dict["dm_ckp_path"]` into
    `model.dm_decoder` (LDMSlotFormer's frozen LDM, from a SAViDiffusion
    checkpoint's `dm_decoder.` entries; after the VQ-VAE, so it wins, in
    the order of the JAX `pretrained_specs`; its raw parameters, not its
    EMA, as the JAX `apply_pretrained` grafts `params`), the
    dVAE of `cfg.dvae_dict["dvae_ckp_path"]` into `model.dvae` (relative
    to the dVAE, a dVAE run's ckpt_last.pt, or prefixed `dvae.`, a SLATE
    or STEVE checkpoint). Each file is port-format; every parameter must
    be present with its shape (the JAX package's training/checkpoint.py:
    138-150). Every DINO encoder of the model takes the pretrained
    weights of the `.npz` that SLOTDIFFUSION_DINO_WEIGHTS names, when it
    names a file (`models/dino.py:load_dino_weights`, the JAX package's
    `apply_dino_pretrained`). A config without the paths leaves the
    model as it is; returns whether it grafted."""
    vae = (getattr(cfg, "dec_dict", None) or {}).get("vae_dict") or {}
    vq_path = vae.get("vqvae_ckp_path")
    dm_path = (getattr(cfg, "dec_dict", None) or {}).get("dm_ckp_path")
    dvae_path = (getattr(cfg, "dvae_dict", None) or {}).get("dvae_ckp_path")
    if vq_path:
        _graft(vq_path, model.dm_decoder.vae.vqvae, "dm_decoder.vae.vqvae.",
               "VQ-VAE")
    if dm_path:
        _graft(dm_path, model.dm_decoder, "dm_decoder.", "diffusion decoder",
               raw=True)
    if dvae_path:
        _graft(dvae_path, model.dvae, "dvae.", "dVAE")
    from ..models.dino import WEIGHTS_ENV, DINOEncoder, load_dino_weights
    dino = False
    for m in model.modules():
        if isinstance(m, DINOEncoder) and load_dino_weights(m)[1]:
            dino = True
            print(f"DINO: pretrained weights from {os.environ[WEIGHTS_ENV]}",
                  flush=True)
    return bool(vq_path or dm_path or dvae_path or dino)
