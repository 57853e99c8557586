"""Serving surfaces of the port as torch callables (mirrors
the JAX package's serving.py:77-135):

- ``encode``  img [B, T, H, W, 3] -> (slots [B, T, S, D],
  masks [B, T, S, H, W]);
- ``sample``  (seed, slots [B, T, S, D]) -> imgs [B, T, H, W, 3]: the
  DPM-Solver++ chain over the B*T frames, then VQ decode;
- ``denoise`` (x_t [B*T, h, w, C], t [B*T], slots) -> the UNet output.

Each runs under `torch.inference_mode` on the model's device. There is no
exported artifact and no HTTP server in the port yet.
"""

import torch


def _fold(slots):
    return slots.reshape(-1, *slots.shape[-2:]) if slots.dim() == 4 \
        else slots


def build_serving_fn(model, what):
    """-> callable for one surface of a built SAViDiffusion `model`."""
    device = next(model.parameters()).device

    if what == "encode":
        @torch.inference_mode()
        def encode(img):
            out = model({"img": img.to(device)})
            return out["slots"], out["masks"]
        return encode

    if what == "sample":
        @torch.inference_mode()
        def sample(seed, slots):
            gen = torch.Generator(device=device).manual_seed(int(seed))
            slots = slots.to(device)
            dm = model.dm_decoder
            x = dm.decode_latent(dm.generate_imgs(gen, cond=_fold(slots)))
            if slots.dim() == 4:
                x = x.reshape(*slots.shape[:2], *x.shape[1:])
            return x
        return sample

    if what == "denoise":
        @torch.inference_mode()
        def denoise(x, t, slots):
            return model.dm_decoder.denoise(
                x.to(device), t.to(device), _fold(slots.to(device)))
        return denoise

    raise ValueError(f"unknown serving surface {what!r}")
