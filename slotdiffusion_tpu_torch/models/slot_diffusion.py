"""SAViDiffusion: SAVi with masked slot attention + a slot-conditioned
LDM over the B*T frames (mirrors the JAX package's models/
slot_diffusion.py:30-64, 160-245): the encoder, the training loss
(`compute_losses`) and the slot-conditioned reconstruction
(`log_images`). `compute_dtype` (bf16 under `use_bf16`) reaches SAVi, the
UNet and the VQ-VAE, as the JAX model passes its `dtype` down
(models/slot_diffusion.py:38-61, 97-109 of the JAX package): slots come
out in it, masks, latents and images in f32."""

import torch
import torch.nn.functional as F
from torch import nn

from .diffusion import LDM
from .savi import SAVi


def _upsample_masks(masks, vis_res, out_res):
    """[B, N, h*w] -> [B, N, H, W], bilinear (half-pixel centers)."""
    B, N = masks.shape[:2]
    m = masks.reshape(B * N, 1, *vis_res)
    m = F.interpolate(m, size=tuple(out_res), mode="bilinear",
                      align_corners=False)
    return m.reshape(B, N, *out_res)


def _build_dm_decoder(dec_dict, compute_dtype):
    """The latent-diffusion decoder; pixel-space decoders are not ported."""
    dd = dict(dec_dict)
    if not dd.get("vae_dict"):
        raise ValueError("only the latent (VQ-VAE) decoder is ported")
    return LDM(resolution=tuple(dd["resolution"]),
               unet_dict=dd["unet_dict"],
               diffusion_dict=dd.get("diffusion_dict", {}),
               vae_dict=dd["vae_dict"],
               conditioning_key=dd.get("conditioning_key", "crossattn"),
               compute_dtype=compute_dtype)


class SAViDiffusion(nn.Module):
    def __init__(self, resolution, slot_dict, enc_dict, dec_dict, pred_dict,
                 eps=1e-6, compute_dtype=torch.float32):
        super().__init__()
        self.resolution = tuple(resolution)
        self.num_slots = slot_dict["num_slots"]
        self.slot_size = slot_dict["slot_size"]
        self.compute_dtype = compute_dtype
        self.savi = SAVi(self.resolution, slot_dict, enc_dict, pred_dict,
                         eps=eps, compute_dtype=compute_dtype)
        self.dm_decoder = _build_dm_decoder(dec_dict, compute_dtype)
        # the JAX model's `use_ema` (models/slot_diffusion.py:176-178): the
        # decoder's config may ask for an EMA of `dm_decoder`
        self.use_ema = bool(dec_dict.get("use_ema", False))

    def encode(self, img, prev_slots=None, train=False):
        """img [B, T, H, W, 3] -> slots [B, T, S, D], masks
        [B, T, S, H, W] (at the visual resolution when `train`)."""
        slots, masks, vis_res = self.savi.encode(img, prev_slots)
        B, T, N = masks.shape[:3]
        if not train and vis_res != self.resolution:
            m = _upsample_masks(masks.reshape(B * T, N, -1), vis_res,
                                self.resolution)
            return slots, m.reshape(B, T, N, *self.resolution)
        return slots, masks.reshape(B, T, N, *vis_res)

    def forward(self, data_dict, prev_slots=None, train=False):
        slots, masks = self.encode(data_dict["img"], prev_slots, train)
        return {"slots": slots, "masks": masks}

    def compute_losses(self, data_dict, generator=None, t=None, noise=None,
                       train=True):
        """Encode the clips, fold T into the batch and take the LDM's
        denoising loss of every frame conditioned on its slots. -> (out,
        {"denoise_loss": scalar}). `generator` draws t, the noise and the
        dropout masks; tests pass `t` and `noise` instead. `train=False`
        (validation) returns the masks at the input's resolution; dropout
        follows the module's mode."""
        out = self(data_dict, train=train)
        img = data_dict["img"]
        B, T = img.shape[:2]
        losses = self.dm_decoder.loss_function(
            img.reshape(B * T, *img.shape[2:]),
            out["slots"].reshape(B * T, self.num_slots, self.slot_size),
            generator, t=t, noise=noise)
        return out, losses

    def log_images(self, data_dict, generator=None, use_dpm=True,
                   same_noise=True, x_T=None):
        """Slot-conditioned video reconstruction: encode, DPM-Solver++ over
        the B*T frames (one noise sample shared by default), VQ decode."""
        out = self(data_dict)
        B, T = data_dict["img"].shape[:2]
        cond = out["slots"].reshape(B * T, self.num_slots, self.slot_size)
        samples = self.dm_decoder.generate_imgs(
            generator, cond=cond, use_dpm=use_dpm, same_noise=same_noise,
            x_T=x_T)
        samples = self.dm_decoder.decode_latent(samples)
        return {"samples": samples.reshape(B, T, *samples.shape[1:]),
                "masks": out["masks"], "slots": out["slots"]}
