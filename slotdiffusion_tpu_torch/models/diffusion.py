"""Slot-conditioned diffusion decoders for sampling (mirrors
the JAX package's models/diffusion.py:40-160, 304-361, 372-413):
`CondDDPM.denoise`, `sample_dpm` / `generate_imgs(use_dpm=True)` and the
LDM's VQ-VAE encode / quantize / decode with quantize-as-denoise. Only
the "crossattn" conditioning of the flagship is ported; training losses
and the ancestral / DDIM samplers are later work.

Latents and images are NHWC at every public method, as in the JAX package.
"""

import torch
from torch import nn

from ..ops.dpm_solver import dpm_solver_sample
from .schedules import make_beta_schedule
from .unet import UNetModel
from .vqvae import VQVAEWrapper


def _noise(generator, shape, same_noise, device):
    if generator is None:
        raise ValueError("sampling needs a torch.Generator or x_T")
    n = torch.randn((1, *shape[1:]) if same_noise else shape,
                    generator=generator, device=generator.device)
    return n.to(device).expand(shape).contiguous()


class CondDDPM(nn.Module):
    def __init__(self, resolution, unet_dict, diffusion_dict,
                 conditioning_key="crossattn"):
        super().__init__()
        if conditioning_key != "crossattn":
            raise ValueError(f"conditioning {conditioning_key!r} is not "
                             "ported")
        d = dict(diffusion_dict)
        self.pred_target = d.get("pred_target", "eps")
        self.betas = make_beta_schedule(
            d.get("beta_schedule", "linear"), d.get("timesteps", 1000),
            d.get("linear_start", 1e-4), d.get("linear_end", 2e-2))
        self.num_timesteps = len(self.betas)
        self.resolution = tuple(resolution)
        ud = dict(unet_dict)
        self.channels = ud.get("in_channels", 3)
        self.unet = UNetModel(
            in_channels=self.channels,
            model_channels=ud["model_channels"],
            out_channels=ud["out_channels"],
            num_res_blocks=ud["num_res_blocks"],
            attention_resolutions=tuple(ud["attention_resolutions"]),
            dropout=ud.get("dropout", 0.0),
            channel_mult=tuple(ud.get("channel_mult", (1, 2, 4, 8))),
            num_head_channels=ud.get("num_head_channels", 32),
            transformer_depth=ud.get("transformer_depth", 1),
            context_dim=ud.get("context_dim"),
            attn_backend=ud.get("attn_backend", "einsum"),
            attn_softmax=ud.get("attn_softmax", "fast"),
            fused_gn=ud.get("fused_gn", False))

    def denoise(self, x, t, context):
        """x [B, H, W, C] NHWC, t [B], context [B, S, D] -> NHWC output."""
        out = self.unet(x.permute(0, 3, 1, 2).contiguous(), t, context)
        return out.permute(0, 2, 3, 1)

    forward = denoise

    def correct_x0(self, x0):
        """The DPM path's x0 correction. Pixel space takes dynamic
        thresholding, which is not ported; the LDM quantizes."""
        raise NotImplementedError("pixel-space DPM sampling is not ported")

    def sample_dpm(self, generator=None, cond=None, batch_size=None,
                   steps=None, order=3, same_noise=False, x_T=None):
        B = batch_size or cond.shape[0]
        shape = (B, *self.resolution, self.channels)
        device = self.unet.out[2].weight.device
        if x_T is None:
            x_T = _noise(generator, shape, same_noise, device)
        steps = steps or max(20, self.num_timesteps // 50)

        def model_fn(x, t_cont):
            # continuous time -> model time, `(t - 1/N) * 1000` at any N
            tb = (t_cont - 1.0 / self.num_timesteps) * 1000.0
            t = torch.full((B,), tb, dtype=torch.float32, device=x.device)
            return self.denoise(x, t, cond)

        return dpm_solver_sample(
            model_fn, self.betas, x_T, steps=steps, order=order,
            model_type=self.pred_target, correcting_x0_fn=self.correct_x0)

    def generate_imgs(self, generator=None, cond=None, batch_size=None,
                      use_dpm=True, same_noise=False, x_T=None):
        """DPM-Solver++ sampling (steps = max(20, T/50), order 3)."""
        if not use_dpm:
            raise ValueError("only DPM-Solver sampling is ported")
        return self.sample_dpm(generator, cond=cond, batch_size=batch_size,
                               same_noise=same_noise, x_T=x_T)


class LDM(CondDDPM):
    """Latent diffusion over a frozen VQ-VAE (`vae`): quantize-as-denoise
    is the x0 correction."""

    def __init__(self, resolution, unet_dict, diffusion_dict, vae_dict,
                 conditioning_key="crossattn"):
        super().__init__(resolution, unet_dict, diffusion_dict,
                         conditioning_key)
        self.vae = VQVAEWrapper(vae_dict["enc_dec_dict"],
                                vae_dict["vq_dict"],
                                diffusion_dict.get("z_scale_factor", 1.0))

    def correct_x0(self, x0):
        return self.vae.quantize(x0)

    def encode_latent(self, img):
        return self.vae.encode(img)

    def decode_latent(self, z):
        return self.vae.decode(z)
