"""Flagship configuration of the port: SAViDiffusion on MOVi-E, 128x128.

An own copy of the settings of the JAX package's `configs_base.py:17-140,
274-330` and `configs/video_based/savi_ldm/savi_ldm_movie_params-res128.py`
(the port imports nothing of the JAX package), with `BaseParams` copied
from the JAX package's `utils/config.py`.

Three knobs differ from the JAX flagship, and they are why the port's
main path runs its kernels:

- `fused_gn=True`: every UNet ResBlock GN+SiLU and SpatialTransformer GN
  runs the GN(+SiLU) kernel (the JAX default is False);
- `attn_backend="fused"`: every UNet self- and cross-attention runs the
  attention kernel (the JAX default is "einsum"). The kernel's softmax is
  the clamped-exp form, so `attn_softmax` is ignored on this path, as in
  the JAX package;
- `use_pallas=True`: every SAVi frame runs the slot-attention kernel
  (the JAX default "auto" resolves to False).
"""

import copy


class BaseParams:
    """Mutable attribute-bag config: class attributes are defaults,
    keyword arguments override them."""

    def __init__(self, **overrides):
        for k, v in overrides.items():
            setattr(self, k, v)

    def copy(self, **overrides):
        new = copy.deepcopy(self)
        for k, v in overrides.items():
            setattr(new, k, v)
        return new


def vae_dict_for(resolution, img_ch=3, latent_ch=3):
    """Taming-style VQ-VAE, ch 64, ch_mult (1, 2, 4), 4096 codes."""
    return dict(
        vae_type="VQVAE",
        enc_dec_dict=dict(
            resolution=resolution[0], in_channels=img_ch,
            z_channels=latent_ch, ch=64, ch_mult=[1, 2, 4],
            num_res_blocks=2, attn_resolutions=[], out_ch=img_ch,
            dropout=0.0),
        vq_dict=dict(n_embed=4096, embed_dim=latent_ch),
    )


def ldm_unet_dict(slot_size, latent_ch=3):
    return dict(
        in_channels=latent_ch, model_channels=128, out_channels=latent_ch,
        num_res_blocks=2, attention_resolutions=(8, 4, 2), dropout=0.1,
        channel_mult=(1, 2, 3, 4), num_head_channels=32,
        context_dim=slot_size, attn_softmax="stable",
        fused_gn=True, attn_backend="fused")


def ldm_dec_dict(resolution, slot_size, latent_ch=3, timesteps=1000):
    return dict(
        resolution=tuple(r // 4 for r in resolution),
        vae_dict=vae_dict_for(resolution, latent_ch=latent_ch),
        unet_dict=ldm_unet_dict(slot_size, latent_ch),
        diffusion_dict=dict(
            pred_target="eps", z_scale_factor=1.0, timesteps=timesteps,
            beta_schedule="linear", linear_start=0.0015,
            linear_end=0.0195),
        conditioning_key="crossattn")


class SAViLDMMoviE128(BaseParams):
    """SAViDiffusion on MOVi-E at 128x128 (savi_ldm_movie_params-res128)."""
    model = "SAViDiffusion"
    resolution = (128, 128)
    n_sample_frames = 6
    slot_dict = dict(num_slots=15, slot_size=192, slot_mlp_size=384,
                     num_iterations=2, use_pallas=True)
    enc_dict = dict(resnet="resnet18", use_layer4=False,
                    enc_out_channels=192,
                    replace_stride_with_dilation=[False, False, False])
    dec_dict = ldm_dec_dict((128, 128), 192)
    pred_dict = dict(pred_type="transformer", pred_rnn=False,
                     pred_norm_first=True, pred_num_layers=2,
                     pred_num_heads=4, pred_ffn_dim=192 * 4)
