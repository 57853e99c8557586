"""Compositional generation (the counterpart of the JAX package's
scripts/test_comp_gen.py:23-95): slots of a batch are recombined across
its samples (`shuffle_slots`) and decoded into novel scenes by the
model's own decoder (`decode_slots`). The script
(`scripts/test_comp_gen_torch.py`), the tests and the card's smoke run
share these two functions."""

import torch

from ..models.diffusion import LDM

DIFFUSION = ("SADiffusion", "SAViDiffusion")
TOKEN = ("SLATE", "STEVE")


def encode_slots(model, params, img):
    """The slots [B, (T,) N, C] of images [B, H, W, 3] or clips [B, T, H,
    W, 3] (the decoders of SA, SAVi, SLATE and STEVE not run)."""
    if params.model in DIFFUSION:
        return model({"img": img})["slots"]
    return model({"img": img}, testing=True)["slots"]


def shuffle_slots(slots):
    """slots [B, (T,) N, C] -> the same shape with slot k of sample b taken
    from sample (b - k) mod B (slot k rolled k places over the batch, as
    `np.roll(..., shift=k, axis=0)`); slot 0 stays."""
    return torch.stack([torch.roll(slots[..., k, :], shifts=k, dims=0)
                        for k in range(slots.shape[-2])], dim=-2)


def decode_slots(model, params, slots, generator=None, x_T=None,
                 **options):
    """Frames [B * T (or B), H, W, 3] in [-1, 1] decoded from slots [B, (T,)
    N, C] by `model` as `params.model` names it: a diffusion model by
    DPM-Solver++ (`same_noise` as the config gives it, True by default;
    `x_T` the starting noise if given) and, for an LDM, the VQ decode;
    SLATE and STEVE by the AR decoder's greedy tokens and the dVAE; SA
    and SAVi by the spatial broadcast decoder. `generator` draws the
    noise; `options` go to DPM-Solver (`steps`, `order`, ...)."""
    flat = slots.reshape(-1, *slots.shape[-2:])
    name = params.model
    if name in DIFFUSION:
        dm = model.dm_decoder
        x = dm.generate_imgs(generator, cond=flat, use_dpm=True,
                             same_noise=getattr(params, "same_noise", True),
                             x_T=x_T, **options)
        return dm.decode_latent(x) if isinstance(dm, LDM) else x
    if name in TOKEN:
        return model.recon_img(flat, generator)
    if name in ("SA", "SAVi"):
        return model.decode(flat)[0]
    raise ValueError(f"compositional generation of {name!r} is not defined")
