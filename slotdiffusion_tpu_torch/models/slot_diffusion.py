"""SlotDiffusion: slot attention with its last-iteration masks + a
slot-conditioned diffusion decoder (an LDM, or a pixel-space CondDDPM
when the config has no VQ-VAE), on images (`SADiffusion`) and on video
(`SAViDiffusion`, SAVi over the B*T frames) (mirrors the JAX package's
models/slot_diffusion.py:30-245): the encoder, the training loss
(`compute_losses`) and the slot-conditioned reconstruction
(`log_images`, through any sampler of the decoder). `compute_dtype`
(bf16 under `use_bf16`) reaches the encoder, slot attention, the UNet
and the VQ-VAE, as the JAX model passes its `dtype` down
(models/slot_diffusion.py:38-61, 97-109 of the JAX package): slots come
out in it, masks, latents and images in f32."""

import torch
import torch.nn.functional as F
from torch import nn

from .diffusion import LDM, CondDDPM
from .sa import SlotEncoding
from .savi import SAVi


def _upsample_masks(masks, vis_res, out_res):
    """[B, N, h*w] -> [B, N, H, W], bilinear (half-pixel centers)."""
    B, N = masks.shape[:2]
    m = masks.reshape(B * N, 1, *vis_res)
    m = F.interpolate(m, size=tuple(out_res), mode="bilinear",
                      align_corners=False)
    return m.reshape(B, N, *out_res)


def _build_dm_decoder(dec_dict, compute_dtype):
    """An LDM when `dec_dict` has a `vae_dict`, else a pixel-space
    CondDDPM."""
    dd = dict(dec_dict)
    kw = dict(resolution=tuple(dd["resolution"]), unet_dict=dd["unet_dict"],
              diffusion_dict=dd.get("diffusion_dict", {}),
              conditioning_key=dd.get("conditioning_key", "crossattn"),
              compute_dtype=compute_dtype)
    if dd.get("vae_dict"):
        return LDM(vae_dict=dd["vae_dict"], **kw)
    return CondDDPM(**kw)


def encode_video(savi, resolution, img, prev_slots=None, train=False):
    """`SAViDiffusion.encode` through the `savi` encoder alone (the serving
    surface `encode` holds nothing else)."""
    slots, masks, vis_res = savi.encode(img, prev_slots)
    B, T, N = masks.shape[:3]
    if not train and vis_res != tuple(resolution):
        m = _upsample_masks(masks.reshape(B * T, N, -1), vis_res,
                            resolution)
        return slots, m.reshape(B, T, N, *resolution)
    return slots, masks.reshape(B, T, N, *vis_res)


def encode_image(m, resolution, img, init_slots=None, train=False):
    """`SADiffusion.encode` through `m`'s `encoder`, `slot_attention` and
    `init_latents` alone (the serving surface `encode` holds nothing
    else): img [B, H, W, 3] -> slots [B, S, D], masks [B, S, H, W] (at
    the visual resolution when `train`, else bilinearly upsampled to
    `resolution`)."""
    feats, vis_res = m.encoder(img)
    if init_slots is None:
        init_slots = SlotEncoding.init_slots(m, img.shape[0])
    slots, masks = m.slot_attention(feats, init_slots)
    if not train and vis_res != tuple(resolution):
        return slots, _upsample_masks(masks, vis_res, resolution)
    return slots, masks.reshape(*masks.shape[:2], *vis_res)


class SADiffusion(SlotEncoding):
    """SlotDiffusion on NHWC images [B, H, W, 3]."""

    # the subtree an EMA covers (the JAX `ema_filter_prefix`)
    ema_prefix = "dm_decoder."

    def __init__(self, resolution, slot_dict, enc_dict, dec_dict, eps=1e-6,
                 compute_dtype=torch.float32):
        super().__init__(resolution, slot_dict, enc_dict, eps,
                         return_last_attn=True, compute_dtype=compute_dtype)
        self.dm_decoder = _build_dm_decoder(dec_dict, compute_dtype)
        self.use_ema = bool(dec_dict.get("use_ema", False))

    @property
    def frozen_modules(self):
        """What the trainer freezes: a DINO encoder and the stage-1 VQ-VAE
        of an LDM."""
        return self.frozen_encoder + ((self.dm_decoder.vae,) if isinstance(
            self.dm_decoder, LDM) else ())

    def encode(self, img, init_slots=None, train=False):
        """img [B, H, W, 3] -> slots [B, S, D], masks [B, S, H, W] (at the
        visual resolution when `train`)."""
        return encode_image(self, self.resolution, img, init_slots, train)

    def forward(self, data_dict, train=False, testing=False):
        slots, masks = self.encode(data_dict["img"], train=train)
        return {"slots": slots, "masks": masks}

    def compute_losses(self, data_dict, generator=None, t=None, noise=None,
                       train=True):
        """The decoder's denoising loss of each image conditioned on its
        slots. -> (out, {"denoise_loss": scalar}). `generator` draws t,
        the noise and the dropout masks; tests pass `t` and `noise`
        instead. `train=False` (validation) returns the masks at the
        input's resolution; dropout follows the module's mode."""
        out = self(data_dict, train=train)
        losses = self.dm_decoder.loss_function(
            data_dict["img"], out["slots"], generator, t=t, noise=noise)
        return out, losses

    def log_images(self, data_dict, generator=None, use_dpm=True,
                   same_noise=False, ret_intermed=False, **kwargs):
        """Slot-conditioned reconstruction: encode, sample (DPM-Solver++
        by default, a fresh noise sample per image; `kwargs` go to
        `generate_imgs`: x_T, noise, a sampler's options), then the LDM's
        VQ decode. `ret_intermed` samples by DDIM and also returns its
        trajectory, each step VQ-decoded: "intermed" [K, B, H, W, 3],
        x_T first."""
        out = self(data_dict)
        samples = self.dm_decoder.generate_imgs(
            generator, cond=out["slots"], use_dpm=use_dpm and not
            ret_intermed, use_ddim=ret_intermed, same_noise=same_noise,
            ret_intermed=ret_intermed, **kwargs)
        intermed = None
        if ret_intermed:
            samples, intermed = samples
        if isinstance(self.dm_decoder, LDM):
            samples = self.dm_decoder.decode_latent(samples)
            if intermed is not None:
                dec = self.dm_decoder.decode_latent(intermed.flatten(0, 1))
                intermed = dec.reshape(*intermed.shape[:2], *dec.shape[1:])
        ret = {"samples": samples, "masks": out["masks"],
               "slots": out["slots"]}
        if intermed is not None:
            ret["intermed"] = intermed
        return ret


class SAViDiffusion(nn.Module):
    def __init__(self, resolution, slot_dict, enc_dict, dec_dict, pred_dict,
                 eps=1e-6, compute_dtype=torch.float32):
        super().__init__()
        self.resolution = tuple(resolution)
        self.num_slots = slot_dict["num_slots"]
        self.slot_size = slot_dict["slot_size"]
        self.compute_dtype = compute_dtype
        self.savi = SAVi(self.resolution, slot_dict, enc_dict, pred_dict,
                         eps=eps, return_mask=True,
                         compute_dtype=compute_dtype)
        self.dm_decoder = _build_dm_decoder(dec_dict, compute_dtype)
        # the JAX model's `use_ema` (models/slot_diffusion.py:176-178): the
        # decoder's config may ask for an EMA of `dm_decoder`
        self.use_ema = bool(dec_dict.get("use_ema", False))

    # the subtree an EMA covers (the JAX `ema_filter_prefix`)
    ema_prefix = "dm_decoder."

    @property
    def frozen_modules(self):
        """What the trainer freezes: the stage-1 VQ-VAE of an LDM."""
        return (self.dm_decoder.vae,) if isinstance(self.dm_decoder, LDM) \
            else ()

    def encode(self, img, prev_slots=None, train=False):
        """img [B, T, H, W, 3] -> slots [B, T, S, D], masks
        [B, T, S, H, W] (at the visual resolution when `train`)."""
        return encode_video(self.savi, self.resolution, img, prev_slots,
                            train)

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
                   same_noise=True, **kwargs):
        """Slot-conditioned video reconstruction: encode, sample the B*T
        frames (DPM-Solver++ and one noise sample shared by default;
        `kwargs` go to `generate_imgs`: use_ddim, x_T, noise, a sampler's
        options), then the LDM's VQ decode."""
        out = self(data_dict)
        B, T = data_dict["img"].shape[:2]
        cond = out["slots"].reshape(B * T, self.num_slots, self.slot_size)
        samples = self.dm_decoder.generate_imgs(
            generator, cond=cond, use_dpm=use_dpm, same_noise=same_noise,
            **kwargs)
        if isinstance(self.dm_decoder, LDM):
            samples = self.dm_decoder.decode_latent(samples)
        return {"samples": samples.reshape(B, T, *samples.shape[1:]),
                "masks": out["masks"], "slots": out["slots"]}
