"""Configurations of the port: the flagship SAViDiffusion on MOVi-E,
128x128 (`SAViLDMMoviE128`), its MOVi-D, -Solid and -Tex siblings, the
repo's trained 64x64 SAViDiffusion (`SAViLDMMoviFile64`), and the
stage-1 VQ-VAEs: the flagship's (`VQVAEMoviE128`) and its siblings, and
the repo's two trained 64x64 ones (`VQVAESynthetic64`,
`VQVAESyntheticLPIPS64`). The image family: SADiffusion on CLEVRTex and
CelebA at 128x128 (`SALDMCLEVRTex128`, `SALDMCelebA128`) with their
stage-1 VQ-VAEs (`VQVAECLEVRTex128`, `VQVAECelebA128`), the SA baseline
on both (`SACLEVRTex128`, `SACelebA128`), and the repo's two trained
64x64 image models (`SASyntheticLong64`, `SALDMSyntheticLong64`). The
token and reconstruction baselines: SAVi on MOVi-E and its siblings
(`SAViMoviE128`, ...), STEVE (`STEVEMoviE128`, ...) with its stage-1
dVAE (`DVAEMoviE128`, ...), SLATE on CLEVRTex and CelebA
(`SLATECLEVRTex128`, `SLATECelebA128`) with theirs (`DVAECLEVRTex128`,
`DVAECelebA128`), and the repo's four trained 64x64 ones
(`SAViSynthetic64`, `DVAESyntheticLong64`, `SLATESyntheticLong64`,
`STEVESyntheticLong64`). The real-world images: SADiffusion with a
frozen DINO ViT-S/8 on COCO and VOC at 224x224 (`SALDMDINOCOCO224`,
`SALDMDINOVOC224`) with their stage-1 VQ-VAEs (`VQVAECOCO224`,
`VQVAEVOC224`), and the repo's 64x64 SA on its COCO, VOC and
synthetic-COCO trees (`SACOCOFile64`, `SAVOCFile64`,
`SASyntheticCOCO64`, over `SASynthetic64`). The video-prediction and VQA
stage: on Physion at full width, SAViDiffusion with 8 slots
(`SAViLDMPhysion128`) and its VQ-VAE (`VQVAEPhysion128`), LDMSlotFormer
over its slots (`LDMSlotFormerPhysion128`) and the VQA readout
(`ReadoutPhysion`); the repo's trained synthetic chain: the extraction
model `SAViLDMSyntheticLong3_64`, `SlotFormerSynthetic`,
`LDMSlotFormerSynthetic64` and its `Long2` and `Long3` runs,
`ReadoutSynthetic` and `ReadoutSyntheticRolloutLong`. Each names the
JAX config it copies.

An own copy of the settings of the JAX package's `configs_base.py:17-140,
274-330` and `configs/video_based/savi_ldm/savi_ldm_movie_params-res128.py`
(the port imports nothing of the JAX package), with `BaseParams` copied
from the JAX package's `utils/config.py`. The training settings are
`SAViLDMBase`'s (`configs_base.py:308-330`). The JAX config names an orbax
stage-1 VQ-VAE (`vqvae_ckp_path`), which the port cannot read; the port's
config leaves it unset (a random VQ-VAE), and a user points
`dec_dict["vae_dict"]["vqvae_ckp_path"]` at a port-format file
(`training/checkpoint.py:graft_pretrained`).

Three knobs differ from the JAX flagship, and they are why the port's
main path runs its kernels:

- `fused_gn=True`: every UNet ResBlock GN+SiLU and SpatialTransformer GN
  runs the GN(+SiLU) kernel (the JAX default is False);
- `attn_backend="fused"`: every UNet self- and cross-attention runs the
  attention kernel (the JAX default is "einsum"). The kernel's softmax is
  the clamped-exp form, so `attn_softmax` is ignored on this path, as in
  the JAX package;
- `use_pallas=True`: every SAVi frame runs the slot-attention kernel
  (the JAX default "auto" resolves to False, in the port as in the JAX
  package).

`use_bf16` (False, the JAX default; `scripts/train.py --bf16` of the JAX
package, `scripts/train_torch.py --bf16` here) builds the model in bf16 as
the JAX package does: f32 parameters, each layer computing in bf16
(`models/blocks.py`), the GN and attention kernels through their bf16
entry points.
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
    # training (SAViLDMBase, and the JAX trainer's defaults)
    seed = 0
    max_epochs = 30
    save_interval = 0.1   # of an epoch
    print_iter = 50
    lr = 1e-4
    dec_lr = 2e-4         # the dm_decoder group's max LR
    min_lr = 0.0
    clip_grad = 0.05      # <= 0: no clipping
    warmup_steps_pct = 0.05
    grad_accum_steps = 1
    use_ema = False       # an EMA of the dm_decoder, swapped in at eval
    ema_decay = 0.9999
    train_batch_size = 32
    val_batch_size = 32
    eval_interval = 1     # epochs between validations
    denoise_loss_w = 1.0
    use_bf16 = False      # compute dtype bf16, parameters f32
    # data (configs_base.py:_VideoCommon, _Common)
    dataset = "movi"
    movi_level = "e"
    data_root = "./data/MOVi"
    frame_offset = 1
    video_len = 24
    load_mask = True
    num_workers = 8
    # model
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


def tiny_config(resolution=(16, 16), num_slots=3, slot_size=32,
                timesteps=50, use_pallas=True, use_bf16=False):
    """The flagship's structure at narrow widths, for CPU runs and tests:
    GN-ResNet18 encoder, 2-iteration SA, 1-layer predictor, a 2-level UNet
    with attention at both levels, a 3-level VQ-VAE with 64 codes, no
    dropout, 2 clips a step; the three kernel knobs as in the flagship,
    and the compute dtype `use_bf16` asks for."""
    unet = dict(ldm_unet_dict(slot_size), model_channels=32,
                num_res_blocks=1, attention_resolutions=(1, 2),
                channel_mult=(1, 2), num_head_channels=32, dropout=0.0)
    vae = vae_dict_for(resolution)
    vae["enc_dec_dict"] = dict(vae["enc_dec_dict"], ch=8)
    vae["vq_dict"] = dict(n_embed=64, embed_dim=3)
    dec = ldm_dec_dict(resolution, slot_size, timesteps=timesteps)
    dec.update(unet_dict=unet, vae_dict=vae)
    return SAViLDMMoviE128().copy(
        train_batch_size=2,
        use_bf16=use_bf16,
        resolution=tuple(resolution),
        slot_dict=dict(num_slots=num_slots, slot_size=slot_size,
                       slot_mlp_size=2 * slot_size, num_iterations=2,
                       use_pallas=use_pallas),
        enc_dict=dict(SAViLDMMoviE128.enc_dict,
                      enc_out_channels=slot_size),
        dec_dict=dec,
        pred_dict=dict(SAViLDMMoviE128.pred_dict, pred_num_layers=1,
                       pred_num_heads=2, pred_ffn_dim=2 * slot_size))


class SAViLDMMoviFile64(SAViLDMMoviE128):
    """The repo's trained SAViDiffusion: an own copy of the JAX package's
    `configs/savi_ldm_movi_file-res64.py` over its base
    `configs/savi_ldm_synthetic_params-res64.py`, whose checkpoint
    `checkpoint/savi_ldm_movi_file-res64/ckpt_final` the export script
    (`scripts/export_torch_checkpoint.py`) carries into the port.

    64x64 clips of 2 frames from a MOVi-layout tree (JPEG frames,
    grayscale PNG masks, `scripts/gen_movi_tree.py`); 6 slots of 64; the
    plain CNN encoder (3 -> 32 -> 32 -> 32, 5x5, stride 1, no norm); a
    1-layer transformer predictor; a UNet of 32 channels, mult (1, 2),
    attention at (4, 2), heads 8 wide, 200 timesteps, with an EMA of the
    decoder; the VQ-VAE of ch 32, mult (1, 2), 512 codes.

    The JAX config runs no Pallas kernel, and this copy keeps its knobs:
    `use_pallas="auto"`, `fused_gn=False`, `attn_backend="einsum"`. On
    every device it computes what the JAX model computes: slot attention
    in f32 ("auto" resolves to the f32 formula, as in the JAX package),
    GroupNorm and attention in their plain PyTorch versions (the UNet's
    heads are 8 wide, and the attention kernel takes 32). `vqvae_ckp_path`
    is unset: a converted SAViDiffusion
    checkpoint carries its VQ-VAE, and a training run names a port-format
    VQ-VAE file (`scripts/train_torch.py --vqvae_ckp_path`).
    """
    max_epochs = 32
    save_interval = 8.0
    eval_interval = 2
    print_iter = 64
    use_ema = False
    train_batch_size = 8
    val_batch_size = 8
    dataset = "movi"
    movi_level = "e"
    data_root = "data_local/movi_file"
    video_len = 6
    n_sample_frames = 2
    frame_offset = 1
    load_mask = True
    num_workers = 4
    resolution = (64, 64)
    # "auto": slot attention's f32 formula on every device, as in the JAX
    # package
    slot_dict = dict(num_slots=6, slot_size=64, slot_mlp_size=128,
                     num_iterations=2, use_pallas="auto")
    enc_dict = dict(enc_channels=(3, 32, 32, 32), enc_ks=5,
                    enc_out_channels=64, enc_norm="")
    pred_dict = dict(pred_type="transformer", pred_rnn=False,
                     pred_norm_first=True, pred_num_layers=1,
                     pred_num_heads=2, pred_ffn_dim=128)
    dec_dict = dict(
        resolution=(32, 32),
        unet_dict=dict(
            in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(4, 2), dropout=0.0,
            channel_mult=(1, 2), num_head_channels=8, context_dim=64),
        vae_dict=dict(
            vae_type="VQVAE",
            enc_dec_dict=dict(
                resolution=64, in_channels=3, z_channels=3, ch=32,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[],
                out_ch=3, dropout=0.0),
            vq_dict=dict(n_embed=512, embed_dim=3)),
        use_ema=True,
        diffusion_dict=dict(
            pred_target="eps", z_scale_factor=1.0, timesteps=200,
            beta_schedule="linear", linear_start=0.0015,
            linear_end=0.0195),
        conditioning_key="crossattn")


class SAViLDMMoviD128(SAViLDMMoviE128):
    """SAViDiffusion on MOVi-D (savi_ldm_movid_params-res128): the
    flagship on another level."""
    movi_level = "d"


class SAViLDMMoviSolid128(SAViLDMMoviE128):
    """SAViDiffusion on MOVi-Solid (savi_ldm_movisolid_params-res128): 12
    slots, the plain CNN encoder (3 -> 64 x 4, 5x5, no norm;
    configs_base.py:cnn_enc_dict of the JAX package), the STEVE-MOVi data
    layout."""
    movi_level = "Solid"
    dataset = "steve_movi"
    slot_dict = dict(SAViLDMMoviE128.slot_dict, num_slots=12)
    enc_dict = dict(enc_channels=(3, 64, 64, 64, 64), enc_ks=5,
                    enc_out_channels=192, enc_norm="")


class SAViLDMMoviTex128(SAViLDMMoviSolid128):
    """SAViDiffusion on MOVi-Tex (savi_ldm_movitex_params-res128)."""
    movi_level = "Tex"


class VQVAEMoviE128(BaseParams):
    """The flagship's stage 1: the VQ-VAE on single MOVi-E frames at
    128x128 (vqvae_movie_params-res128 over VQVAEVideoBase and
    VQVAEImgBase, configs_base.py:250-268, 369-378 of the JAX package):
    ch 64, ch_mult (1, 2, 4), 2 res blocks, no attention but the mid
    one, 4096 codes of 3, L1 + quant + LPIPS losses, Adam at 1e-3 with 5 %
    warmup and no clipping, 64 frames a step, 50 epochs. Its
    `ckpt_last.pt` is what a SAViDiffusion run takes as
    `vqvae_ckp_path`. `lpips_weights` names the LPIPS `.npz` (None: the
    file `SLOTDIFFUSION_LPIPS_WEIGHTS` names; without one the perceptual
    term is off, as in the JAX package)."""
    seed = 0
    max_epochs = 50
    save_interval = 0.5
    eval_interval = 2
    print_iter = 50
    lr = 1e-3
    min_lr = 0.0
    clip_grad = -1.0
    warmup_steps_pct = 0.05
    grad_accum_steps = 1
    use_ema = False
    ema_decay = 0.9999
    train_batch_size = 64
    val_batch_size = 128
    recon_loss_w = 1.0
    quant_loss_w = 1.0
    percept_loss_w = 1.0
    use_bf16 = False
    lpips_weights = None
    dataset = "movi"
    movi_level = "e"
    data_root = "./data/MOVi"
    n_sample_frames = 1
    frame_offset = 1
    video_len = 24
    load_mask = False
    num_workers = 8
    model = "VQVAE"
    resolution = (128, 128)
    enc_dec_dict = dict(
        resolution=128, in_channels=3, z_channels=3, ch=64,
        ch_mult=[1, 2, 4], num_res_blocks=2, attn_resolutions=[],
        out_ch=3, dropout=0.0)
    vq_dict = dict(n_embed=4096, embed_dim=3, percept_loss_w=1.0)


class VQVAEMoviD128(VQVAEMoviE128):
    """vqvae_movid_params-res128."""
    movi_level = "d"


class VQVAEMoviSolid128(VQVAEMoviE128):
    """vqvae_movisolid_params-res128 (the STEVE-MOVi data layout)."""
    movi_level = "Solid"
    dataset = "steve_movi"


class VQVAEMoviTex128(VQVAEMoviSolid128):
    """vqvae_movitex_params-res128."""
    movi_level = "Tex"


class VQVAESynthetic64(VQVAEMoviE128):
    """The repo's trained stage-1 model: an own copy of the JAX package's
    `configs/vqvae_synthetic_params-res64.py`, whose checkpoint
    `checkpoint/vqvae_synthetic_params-res64/ckpt_last` the export script
    carries into the port (`--vqvae`). Single 64x64 synthetic frames, 128
    train and 16 val, 16 a step, 2 epochs; ch 32, ch_mult (1, 2), 1 res
    block, 512 codes of 3, no perceptual term."""
    max_epochs = 2
    save_interval = 1.0
    eval_interval = 1
    print_iter = 10
    train_batch_size = 16
    val_batch_size = 16
    dataset = "synthetic_video"
    data_root = ""
    train_samples = 128
    val_samples = 16
    max_objects = 4
    video_len = 6
    num_workers = 2
    resolution = (64, 64)
    enc_dec_dict = dict(
        resolution=64, in_channels=3, z_channels=3, ch=32, ch_mult=[1, 2],
        num_res_blocks=1, attn_resolutions=[], out_ch=3, dropout=0.0)
    vq_dict = dict(n_embed=512, embed_dim=3, percept_loss_w=0.0)


class VQVAESyntheticLPIPS64(VQVAESynthetic64):
    """`configs/vqvae_synthetic_lpips-res64.py`: the same with the LPIPS
    term live (trained on `save_random_lpips_npz(seed=0)` weights; its
    checkpoint is `checkpoint/vqvae_synthetic_lpips-res64/ckpt_final`)."""
    vq_dict = dict(n_embed=512, embed_dim=3, percept_loss_w=1.0)
    percept_loss_w = 1.0


def slot_dict_for(num_slots, slot_size, num_iterations, use_pallas=True):
    """slot_dict_for of the JAX `configs_base.py:133-139`: an MLP twice the
    slot size; with the port's kernel knob."""
    return dict(num_slots=num_slots, slot_size=slot_size,
                slot_mlp_size=2 * slot_size, num_iterations=num_iterations,
                use_pallas=use_pallas)


class _ImageCommon(BaseParams):
    """What every image config shares: the JAX `_Common`
    (configs_base.py:142-149) and the port trainer's defaults."""
    seed = 0
    min_lr = 0.0
    grad_accum_steps = 1
    use_ema = False
    ema_decay = 0.9999
    print_iter = 50
    use_bf16 = False
    num_workers = 8
    resolution = (128, 128)
    max_obj = -1          # CLEVRTex: no object-count filter


class SACLEVRTex128(_ImageCommon):
    """The SA baseline on CLEVRTex at 128x128 (an own copy of the JAX
    package's `configs/img_based/sa/sa_clevrtex_params-res128.py` over
    `SAImgBase`, configs_base.py:156-177): 11 slots of 192, 3 iterations,
    the GN-ResNet18 encoder, the spatial broadcast decoder (192 -> 128 x
    4 from 8x8, 5x5 deconvs), the MSE reconstruction loss; Adam at 4e-4,
    2.5 % warmup, no clipping, 64 images a step, 200 epochs. Its slot
    attention runs the kernel (`use_pallas=True`, the no-mask return)."""
    max_epochs = 200
    save_interval = 2
    eval_interval = 5
    lr = 4e-4
    clip_grad = -1.0
    warmup_steps_pct = 0.025
    load_mask = True
    train_batch_size = 64
    val_batch_size = 128
    dataset = "clevrtex"
    data_root = "./data/CLEVRTex"
    model = "SA"
    slot_dict = slot_dict_for(11, 192, 3)
    enc_dict = dict(SAViLDMMoviE128.enc_dict)
    dec_dict = dict(dec_channels=(192, 128, 128, 128, 128),
                    dec_resolution=(8, 8), dec_ks=5, dec_norm="")
    img_recon_loss_w = 1.0


class SACelebA128(SACLEVRTex128):
    """`configs/img_based/sa/sa_celeba_params-res128.py`: 4 slots, no
    masks, 100 epochs."""
    max_epochs = 100
    dataset = "celeba"
    data_root = "./data/CelebA"
    load_mask = False
    slot_dict = slot_dict_for(4, 192, 3)


class SALDMCLEVRTex128(_ImageCommon):
    """SADiffusion on CLEVRTex at 128x128 (an own copy of the JAX
    package's `configs/img_based/sa_ldm/sa_ldm_clevrtex_params-res128.py`
    over `SALDMImgBase`, configs_base.py:180-202): 11 slots of 192, 3
    iterations, the GN-ResNet18 encoder, the flagship's LDM decoder over
    32x32x3 latents; Adam at 1e-4, the dm_decoder at 2e-4, 5 % warmup,
    clipping at 1.0, 64 images a step, 400 epochs. The three kernel knobs
    as in the flagship. The JAX config names an orbax stage-1 VQ-VAE; the
    port's leaves `vqvae_ckp_path` unset (a random VQ-VAE), and a run
    takes a port-format file (`VQVAECLEVRTex128`'s ckpt_last.pt,
    `scripts/train_torch.py --vqvae_ckp_path`)."""
    max_epochs = 400
    save_interval = 2
    eval_interval = 4
    lr = 1e-4
    dec_lr = 2e-4
    clip_grad = 1.0
    warmup_steps_pct = 0.05
    load_mask = True
    train_batch_size = 64
    val_batch_size = 128
    dataset = "clevrtex"
    data_root = "./data/CLEVRTex"
    model = "SADiffusion"
    slot_dict = slot_dict_for(11, 192, 3)
    enc_dict = dict(SAViLDMMoviE128.enc_dict)
    dec_dict = ldm_dec_dict((128, 128), 192)
    denoise_loss_w = 1.0


class SALDMCelebA128(SALDMCLEVRTex128):
    """`configs/img_based/sa_ldm/sa_ldm_celeba_params-res128.py`: 4 slots,
    no masks, 200 epochs, a checkpoint every half epoch, validation every
    2."""
    max_epochs = 200
    save_interval = 0.5
    eval_interval = 2
    dataset = "celeba"
    data_root = "./data/CelebA"
    load_mask = False
    slot_dict = slot_dict_for(4, 192, 3)


class VQVAECLEVRTex128(VQVAEMoviE128):
    """SADiffusion's stage 1 on CLEVRTex
    (`configs/img_based/sa_ldm/vqvae_clevrtex_params-res128.py` over
    `VQVAEImgBase`, configs_base.py:250-268): the flagship's VQ-VAE on
    single images, 100 epochs, a checkpoint every half epoch, validation
    every 4."""
    max_epochs = 100
    eval_interval = 4
    dataset = "clevrtex"
    data_root = "./data/CLEVRTex"
    max_obj = -1


class VQVAECelebA128(VQVAECLEVRTex128):
    """`configs/img_based/sa_ldm/vqvae_celeba_params-res128.py`."""
    dataset = "celeba"
    data_root = "./data/CelebA"


class SASyntheticLong64(_ImageCommon):
    """The repo's trained SA: an own copy of the JAX package's
    `configs/sa_synthetic_long-res64.py` over its base
    `configs/sa_synthetic_params-res64.py`, whose checkpoint
    `checkpoint/sa_synthetic_long-res64/ckpt_final` the export script
    carries into the port. 64x64 synthetic images (512 train, 32 val), 16
    a step, 320 epochs; 6 slots of 128, 3 iterations; the plain CNN
    encoder (3 -> 64 x 4, 5x5, no norm); the decoder 128 -> 64 x 4 from
    8x8; Adam at 4e-4, clipping at 0.05. The JAX config runs no Pallas
    kernel: `use_pallas="auto"` (the f32 formula), as `SAViLDMMoviFile64`."""
    max_epochs = 320
    save_interval = 16.0
    eval_interval = 8
    print_iter = 64
    lr = 4e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.05
    dataset = "synthetic"
    data_root = ""
    train_samples = 512
    val_samples = 32
    max_objects = 4
    load_mask = True
    train_batch_size = 16
    val_batch_size = 16
    num_workers = 2
    model = "SA"
    resolution = (64, 64)
    slot_dict = dict(num_slots=6, slot_size=128, slot_mlp_size=256,
                     num_iterations=3, use_pallas="auto")
    enc_dict = dict(enc_channels=(3, 64, 64, 64, 64), enc_ks=5,
                    enc_out_channels=128, enc_norm="")
    dec_dict = dict(dec_channels=(128, 64, 64, 64, 64),
                    dec_resolution=(8, 8), dec_ks=5, dec_norm="")
    img_recon_loss_w = 1.0


class SALDMSyntheticLong64(_ImageCommon):
    """The repo's trained SADiffusion: an own copy of the JAX package's
    `configs/sa_ldm_synthetic_long-res64.py` over
    `configs/sa_ldm_synthetic_params-res64.py`, whose checkpoint
    `checkpoint/sa_ldm_synthetic_long-res64/ckpt_final` the export script
    carries into the port. 64x64 synthetic images (512 train, 32 val), 8
    a step, 192 epochs; 6 slots of 64, 2 iterations; the plain CNN
    encoder (3 -> 32 x 3); the 64x64 LDM of `SAViLDMMoviFile64` (a UNet
    of 32 channels, 200 timesteps, an EMA of the decoder, the VQ-VAE of
    512 codes). Its knobs keep the JAX config's computation, as
    `SAViLDMMoviFile64`'s: `use_pallas="auto"`, `fused_gn=False`,
    `attn_backend="einsum"`."""
    max_epochs = 192
    save_interval = 16.0
    eval_interval = 8
    print_iter = 64
    lr = 1e-4
    dec_lr = 2e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.05
    dataset = "synthetic"
    data_root = ""
    train_samples = 512
    val_samples = 32
    max_objects = 4
    load_mask = True
    train_batch_size = 8
    val_batch_size = 8
    num_workers = 2
    model = "SADiffusion"
    resolution = (64, 64)
    slot_dict = slot_dict_for(6, 64, 2, use_pallas="auto")
    enc_dict = dict(enc_channels=(3, 32, 32, 32), enc_ks=5,
                    enc_out_channels=64, enc_norm="")
    dec_dict = dict(
        SAViLDMMoviFile64.dec_dict,
        diffusion_dict=dict(SAViLDMMoviFile64.dec_dict["diffusion_dict"],
                            log_every_t=50))
    denoise_loss_w = 1.0


# ---- the token and reconstruction baselines: SAVi, the dVAE, SLATE and
# STEVE (an own copy of the JAX package's configs_base.py:204-247,
# 303-363 and of the configs under configs/video_based/savi, steve and
# configs/img_based/slate). The JAX STEVE and SLATE configs name an orbax
# stage-1 dVAE (`dvae_ckp_path`), which the port cannot read; the port's
# leave it unset (a random dVAE), and a run names a port-format file
# (a dVAE config's ckpt_last.pt; `scripts/train_torch.py
# --dvae_ckp_path`). Slot attention runs the kernel (`use_pallas=True`):
# SAVi's no-mask return, STEVE's and SLATE's masked one.

def transformer_pred_dict(slot_size, num_layers=2, num_heads=4,
                          ffn_dim=None):
    """SAVi's pre-norm transformer predictor (the JAX
    configs_base.py:transformer_pred_dict)."""
    return dict(pred_type="transformer", pred_rnn=False,
                pred_norm_first=True, pred_num_layers=num_layers,
                pred_num_heads=num_heads,
                pred_ffn_dim=ffn_dim or slot_size * 4, pred_sg_every=None)


class _VideoCommon(BaseParams):
    """What the video baselines share: the JAX `_Common` and
    `_VideoCommon` (configs_base.py:142-149, 274-280) and the port
    trainer's defaults."""
    seed = 0
    min_lr = 0.0
    grad_accum_steps = 1
    use_ema = False
    ema_decay = 0.9999
    print_iter = 50
    use_bf16 = False
    num_workers = 8
    resolution = (128, 128)
    dataset = "movi"
    movi_level = "e"
    data_root = "./data/MOVi"
    n_sample_frames = 3
    frame_offset = 1
    video_len = 24
    load_mask = True


class SAViMoviE128(_VideoCommon):
    """The SAVi baseline on MOVi-E at 128x128 (`configs/video_based/savi/
    savi_movie_params-res128.py` over `SAViBase`, configs_base.py:
    283-305): 15 slots of 192, 2 iterations, the GN-ResNet18 encoder,
    the 2-layer transformer predictor, the spatial broadcast decoder
    (192 -> 64 x 4 from 8x8), the MSE reconstruction loss; Adam at 1e-4,
    2.5 % warmup, clipping at 0.05, 32 clips of 3 frames a step, 30
    epochs."""
    max_epochs = 30
    save_interval = 0.25
    eval_interval = 1
    lr = 1e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.025
    train_batch_size = 32
    val_batch_size = 64
    model = "SAVi"
    slot_dict = slot_dict_for(15, 192, 2)
    enc_dict = dict(SAViLDMMoviE128.enc_dict)
    dec_dict = dict(dec_channels=(192, 64, 64, 64, 64),
                    dec_resolution=(8, 8), dec_ks=5, dec_norm="")
    pred_dict = transformer_pred_dict(192)
    loss_dict = dict(use_img_recon_loss=True)
    img_recon_loss_w = 1.0


class SAViMoviD128(SAViMoviE128):
    """savi_movid_params-res128."""
    movi_level = "d"


class SAViMoviSolid128(SAViMoviE128):
    """savi_movisolid_params-res128: 12 slots, the plain CNN encoder, the
    STEVE-MOVi data layout."""
    movi_level = "Solid"
    dataset = "steve_movi"
    slot_dict = slot_dict_for(12, 192, 2)
    enc_dict = dict(SAViLDMMoviSolid128.enc_dict)


class SAViMoviTex128(SAViMoviSolid128):
    """savi_movitex_params-res128."""
    movi_level = "Tex"


class STEVEMoviE128(_VideoCommon):
    """STEVE on MOVi-E at 128x128 (`configs/video_based/steve/
    steve_movie_params-res128.py` over `STEVEBase`, configs_base.py:
    333-355): SAVi's encoder (15 slots of 192, 2 iterations, the
    GN-ResNet18, the transformer predictor) with its masks, the frozen
    dVAE of 4096 tokens a 4x4 patch (32x32 tokens), the AR decoder of 8
    blocks of 192 with 4 heads; the token cross-entropy; Adam at 1e-4,
    the decoder at 3e-4, 5 % warmup, clipping at 0.05, 32 clips of 3
    frames a step, 30 epochs."""
    max_epochs = 30
    save_interval = 0.1
    eval_interval = 1
    lr = 1e-4
    dec_lr = 3e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.05
    train_batch_size = 32
    val_batch_size = 64
    model = "STEVE"
    slot_dict = slot_dict_for(15, 192, 2)
    dvae_dict = dict(down_factor=4, vocab_size=4096)
    enc_dict = dict(SAViLDMMoviE128.enc_dict)
    dec_dict = dict(dec_num_layers=8, dec_num_heads=4, dec_d_model=192)
    pred_dict = transformer_pred_dict(192)
    loss_dict = dict(use_img_recon_loss=False)
    token_recon_loss_w = 1.0
    img_recon_loss_w = 1.0


class STEVEMoviD128(STEVEMoviE128):
    """steve_movid_params-res128."""
    movi_level = "d"


class STEVEMoviSolid128(STEVEMoviE128):
    """steve_movisolid_params-res128: 12 slots, the plain CNN encoder,
    the STEVE-MOVi data layout."""
    movi_level = "Solid"
    dataset = "steve_movi"
    slot_dict = slot_dict_for(12, 192, 2)
    enc_dict = dict(SAViLDMMoviSolid128.enc_dict)


class STEVEMoviTex128(STEVEMoviSolid128):
    """steve_movitex_params-res128."""
    movi_level = "Tex"


class DVAEImg128(_ImageCommon):
    """The dVAE's stage 1 on images (`DVAEImgBase`, configs_base.py:
    228-247): 4096 tokens, gumbel temperature from 1 to 0.1 by a cosine
    over the first 15 % of the steps; Adam at 1e-3, 5 % warmup, no
    clipping, 64 images a step, 100 epochs."""
    max_epochs = 100
    save_interval = 0.5
    eval_interval = 4
    lr = 1e-3
    clip_grad = -1.0
    warmup_steps_pct = 0.05
    load_mask = False
    train_batch_size = 64
    val_batch_size = 128
    model = "dVAE"
    vocab_size = 4096
    dvae_dict = dict(down_factor=4, vocab_size=4096)
    init_tau = 1.0
    final_tau = 0.1
    tau_decay_pct = 0.15
    recon_loss_w = 1.0


class DVAECLEVRTex128(DVAEImg128):
    """`configs/img_based/slate/dvae_clevrtex_params-res128.py`."""
    dataset = "clevrtex"
    data_root = "./data/CLEVRTex"


class DVAECelebA128(DVAEImg128):
    """`configs/img_based/slate/dvae_celeba_params-res128.py`."""
    dataset = "celeba"
    data_root = "./data/CelebA"


class DVAEMoviE128(DVAEImg128):
    """STEVE's stage 1 on single MOVi-E frames (`configs/video_based/
    steve/dvae_movie_params-res128.py` over `DVAEVideoBase`,
    configs_base.py:358-366): 50 epochs, validation every 2. Its
    `ckpt_last.pt` is what a STEVE run takes as `dvae_ckp_path`."""
    max_epochs = 50
    eval_interval = 2
    dataset = "movi"
    movi_level = "e"
    data_root = "./data/MOVi"
    n_sample_frames = 1
    frame_offset = 1
    video_len = 24


class DVAEMoviD128(DVAEMoviE128):
    """dvae_movid_params-res128."""
    movi_level = "d"


class DVAEMoviSolid128(DVAEMoviE128):
    """dvae_movisolid_params-res128 (the STEVE-MOVi data layout)."""
    movi_level = "Solid"
    dataset = "steve_movi"


class DVAEMoviTex128(DVAEMoviSolid128):
    """dvae_movitex_params-res128."""
    movi_level = "Tex"


class SLATECLEVRTex128(_ImageCommon):
    """SLATE on CLEVRTex at 128x128 (`configs/img_based/slate/
    slate_clevrtex_params-res128.py` over `SLATEImgBase`,
    configs_base.py:205-225): 11 slots of 192, 3 iterations, the
    GN-ResNet18 encoder with its masks, the frozen dVAE of 4096 tokens,
    the AR decoder of 8 blocks of 192; the token cross-entropy; Adam at
    1e-4, the decoder at 3e-4, 5 % warmup, clipping at 1.0, 64 images a
    step, 200 epochs."""
    max_epochs = 200
    save_interval = 0.5
    eval_interval = 4
    lr = 1e-4
    dec_lr = 3e-4
    clip_grad = 1.0
    warmup_steps_pct = 0.05
    load_mask = True
    train_batch_size = 64
    val_batch_size = 128
    dataset = "clevrtex"
    data_root = "./data/CLEVRTex"
    model = "SLATE"
    slot_dict = slot_dict_for(11, 192, 3)
    dvae_dict = dict(down_factor=4, vocab_size=4096)
    enc_dict = dict(SAViLDMMoviE128.enc_dict)
    dec_dict = dict(dec_num_layers=8, dec_num_heads=4, dec_d_model=192)
    loss_dict = dict(use_img_recon_loss=False)
    token_recon_loss_w = 1.0
    img_recon_loss_w = 1.0


class SLATECelebA128(SLATECLEVRTex128):
    """`configs/img_based/slate/slate_celeba_params-res128.py`: 4 slots,
    no masks, 100 epochs, validation every 2."""
    max_epochs = 100
    eval_interval = 2
    dataset = "celeba"
    data_root = "./data/CelebA"
    load_mask = False
    slot_dict = slot_dict_for(4, 192, 3)


class SAViSynthetic64(_VideoCommon):
    """The repo's trained SAVi: an own copy of the JAX package's
    `configs/savi_synthetic_params-res64.py`, whose checkpoint
    `checkpoint/savi_synthetic_params-res64/ckpt_last` the export script
    carries into the port. 64x64 synthetic clips of 3 frames (128 train,
    16 val), 8 a step, 2 epochs; 6 slots of 64, 2 iterations; the plain
    CNN encoder (3 -> 32 x 3, 5x5, no norm); a 1-layer transformer
    predictor; the decoder 64 -> 32 x 3 from 8x8; Adam at 1e-4, clipping
    at 0.05. The JAX config runs no Pallas kernel: `use_pallas="auto"`
    (the f32 formula), as `SAViLDMMoviFile64`."""
    max_epochs = 2
    save_interval = 1.0
    eval_interval = 1
    print_iter = 10
    lr = 1e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.05
    dataset = "synthetic_video"
    data_root = ""
    train_samples = 128
    val_samples = 16
    max_objects = 4
    video_len = 6
    train_batch_size = 8
    val_batch_size = 8
    num_workers = 2
    model = "SAVi"
    resolution = (64, 64)
    slot_dict = slot_dict_for(6, 64, 2, use_pallas="auto")
    enc_dict = dict(enc_channels=(3, 32, 32, 32), enc_ks=5,
                    enc_out_channels=64, enc_norm="")
    dec_dict = dict(dec_channels=(64, 32, 32, 32), dec_resolution=(8, 8),
                    dec_ks=5, dec_norm="")
    pred_dict = transformer_pred_dict(64, 1, 2, 128)
    loss_dict = dict(use_img_recon_loss=True)
    img_recon_loss_w = 1.0


class DVAESyntheticLong64(DVAEMoviE128):
    """The repo's trained dVAE: an own copy of the JAX package's
    `configs/dvae_synthetic_long-res64.py` over
    `dvae_synthetic_params-res64.py`, whose checkpoint
    `checkpoint/dvae_synthetic_long-res64/ckpt_final` the export script
    carries into the port (`--model dvae`). Single 64x64 synthetic frames
    (512 train, 32 val), 16 a step, 128 epochs; 512 tokens; the
    temperature annealed over the first 30 % of the steps."""
    max_epochs = 128
    save_interval = 16.0
    eval_interval = 8
    print_iter = 32
    clip_grad = -1.0
    dataset = "synthetic_video"
    data_root = ""
    train_samples = 512
    val_samples = 32
    max_objects = 4
    video_len = 6
    train_batch_size = 16
    val_batch_size = 16
    num_workers = 2
    resolution = (64, 64)
    vocab_size = 512
    dvae_dict = dict(down_factor=4, vocab_size=512)
    tau_decay_pct = 0.3


class SLATESyntheticLong64(_ImageCommon):
    """The repo's trained SLATE: an own copy of the JAX package's
    `configs/slate_synthetic_long-res64.py` over
    `slate_synthetic_params-res64.py`, whose checkpoint
    `checkpoint/slate_synthetic_long-res64/ckpt_final` the export script
    carries into the port. 64x64 synthetic images (512 train, 32 val), 16
    a step, 320 epochs; 6 slots of 64, 2 iterations; the plain CNN
    encoder (3 -> 32 x 3); the dVAE of 512 tokens (16x16 of them); the
    AR decoder of 2 blocks of 64, 4 heads; Adam at 1e-4, the decoder at
    3e-4, clipping at 0.05. `use_pallas="auto"`, as the JAX config."""
    max_epochs = 320
    save_interval = 16.0
    eval_interval = 8
    print_iter = 64
    lr = 1e-4
    dec_lr = 3e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.05
    dataset = "synthetic"
    data_root = ""
    train_samples = 512
    val_samples = 32
    max_objects = 4
    load_mask = True
    train_batch_size = 16
    val_batch_size = 16
    num_workers = 2
    model = "SLATE"
    resolution = (64, 64)
    slot_dict = slot_dict_for(6, 64, 2, use_pallas="auto")
    enc_dict = dict(enc_channels=(3, 32, 32, 32), enc_ks=5,
                    enc_out_channels=64, enc_norm="")
    dvae_dict = dict(down_factor=4, vocab_size=512)
    dec_dict = dict(dec_num_layers=2, dec_num_heads=4, dec_d_model=64)
    loss_dict = dict(use_img_recon_loss=False)
    token_recon_loss_w = 1.0
    img_recon_loss_w = 1.0


class STEVESyntheticLong64(_VideoCommon):
    """The repo's trained STEVE: an own copy of the JAX package's
    `configs/steve_synthetic_long-res64.py` over
    `steve_synthetic_params-res64.py`, whose checkpoint
    `checkpoint/steve_synthetic_long-res64/ckpt_final` the export script
    carries into the port. 64x64 synthetic clips of 2 frames (512 train,
    32 val), 8 a step, 160 epochs; 6 slots of 64, 2 iterations; the
    plain CNN encoder (3 -> 32 x 3); a 1-layer transformer predictor; the
    dVAE of 512 tokens; the AR decoder of 2 blocks of 64; Adam at 1e-4,
    the decoder at 3e-4, clipping at 0.05. `use_pallas="auto"`, as the
    JAX config."""
    max_epochs = 160
    save_interval = 16.0
    eval_interval = 8
    print_iter = 64
    lr = 1e-4
    dec_lr = 3e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.05
    dataset = "synthetic_video"
    data_root = ""
    train_samples = 512
    val_samples = 32
    max_objects = 4
    n_sample_frames = 2
    video_len = 6
    train_batch_size = 8
    val_batch_size = 8
    num_workers = 2
    model = "STEVE"
    resolution = (64, 64)
    slot_dict = slot_dict_for(6, 64, 2, use_pallas="auto")
    enc_dict = dict(enc_channels=(3, 32, 32, 32), enc_ks=5,
                    enc_out_channels=64, enc_norm="")
    pred_dict = transformer_pred_dict(64, 1, 2, 128)
    dvae_dict = dict(down_factor=4, vocab_size=512)
    dec_dict = dict(dec_num_layers=2, dec_num_heads=4, dec_d_model=64)
    loss_dict = dict(use_img_recon_loss=False)
    token_recon_loss_w = 1.0
    img_recon_loss_w = 1.0


# ---- COCO and VOC (an own copy of the JAX package's
# configs/img_based/sa_ldm/{sa_ldm_dino,vqvae}_{coco,voc}_params-res224.py
# over `SALDMImgBase` / `VQVAEImgBase` and `dino_enc_dict`,
# configs_base.py:109-117, 182-202, 250-268, and of configs/sa_coco_file-
# res64.py, sa_voc_file-res64.py and sa_synthetic_coco-res64.py over
# configs/sa_synthetic_params-res64.py)

def dino_enc_dict(slot_size, resolution, patch_size=8, small_size=True):
    """The frozen DINO ViT encoder (ViT-S/8 by default)."""
    return dict(dino="dino-vits8" if small_size else "dino-vitb8",
                enc_out_channels=slot_size, patch_size=patch_size,
                small_size=small_size, resolution=tuple(resolution))


class SALDMDINOCOCO224(_ImageCommon):
    """SADiffusion with a frozen DINO ViT-S/8 on COCO at 224x224: 7 slots
    of 256, 3 iterations, DINO's 28x28 patch tokens (384 channels) under
    the SA encoder's position embedding and MLP head; the flagship's LDM
    decoder over 56x56x3 latents; Adam at 1e-4, the dm_decoder at 2e-4,
    5 % warmup, clipping at 0.05, 64 images a step, 100 epochs. Evaluated
    under the dual inst/sem protocol (`load_anno`). The three kernel
    knobs as in the flagship. The JAX config names an orbax stage-1
    VQ-VAE; the port's leaves `vqvae_ckp_path` unset (a random VQ-VAE),
    and a run takes `VQVAECOCO224`'s ckpt_last.pt. DINO's pretrained
    weights come from the `.npz` SLOTDIFFUSION_DINO_WEIGHTS names
    (`models/dino.py:load_dino_weights`); without it DINO keeps its
    seeded weights."""
    max_epochs = 100
    save_interval = 0.25
    eval_interval = 4
    lr = 1e-4
    dec_lr = 2e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.05
    load_mask = True
    load_anno = True
    train_batch_size = 64
    val_batch_size = 64
    dataset = "coco"
    data_root = "./data/COCO"
    norm_mean = 0.5
    norm_std = 0.5
    model = "SADiffusion"
    resolution = (224, 224)
    slot_dict = slot_dict_for(7, 256, 3)
    enc_dict = dino_enc_dict(256, (224, 224))
    dec_dict = ldm_dec_dict((224, 224), 256)
    denoise_loss_w = 1.0


class SALDMDINOVOC224(SALDMDINOCOCO224):
    """`configs/img_based/sa_ldm/sa_ldm_dino_voc_params-res224.py`: 6 slots
    of 192, 500 epochs, a checkpoint every half epoch, validation every
    10; the VOC trainaug split, its val split's instance masks."""
    max_epochs = 500
    save_interval = 0.5
    eval_interval = 10
    dataset = "voc"
    data_root = "./data/VOC"
    slot_dict = slot_dict_for(6, 192, 3)
    enc_dict = dino_enc_dict(192, (224, 224))
    dec_dict = ldm_dec_dict((224, 224), 192)


class VQVAECOCO224(VQVAECLEVRTex128):
    """`configs/img_based/sa_ldm/vqvae_coco_params-res224.py`: the stage-1
    VQ-VAE on COCO images at 224x224 (56x56x3 latents)."""
    dataset = "coco"
    data_root = "./data/COCO"
    load_anno = False
    norm_mean = 0.5
    norm_std = 0.5
    resolution = (224, 224)
    enc_dec_dict = dict(VQVAECLEVRTex128.enc_dec_dict, resolution=224)


class VQVAEVOC224(VQVAECOCO224):
    """`configs/img_based/sa_ldm/vqvae_voc_params-res224.py`."""
    dataset = "voc"
    data_root = "./data/VOC"


class SASynthetic64(_ImageCommon):
    """`configs/sa_synthetic_params-res64.py`: SA on 64x64 synthetic
    images (256 train, 32 val), 16 a step, 2 epochs; the model of
    `SASyntheticLong64` (6 slots of 128, the plain CNN, the decoder from
    8x8); Adam at 4e-4, clipping at 0.05. Slot attention's f32 formula
    (`use_pallas="auto"`), as the JAX config computes."""
    max_epochs = 2
    save_interval = 1.0
    eval_interval = 1
    print_iter = 10
    lr = 4e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.05
    dataset = "synthetic"
    data_root = ""
    train_samples = 256
    val_samples = 32
    max_objects = 4
    load_mask = True
    train_batch_size = 16
    val_batch_size = 16
    num_workers = 2
    model = "SA"
    resolution = (64, 64)
    slot_dict = dict(SASyntheticLong64.slot_dict)
    enc_dict = dict(SASyntheticLong64.enc_dict)
    dec_dict = dict(SASyntheticLong64.dec_dict)
    img_recon_loss_w = 1.0


class SACOCOFile64(SASynthetic64):
    """`configs/sa_coco_file-res64.py`: the repo's trained SA on its
    generated COCO tree (`scripts/data_utils/gen_mini_seg_data.py
    --coco_train 256 --coco_val 48 --res 96`), 100 epochs, whose
    checkpoint `checkpoint/sa_coco_file-res64/ckpt_final` the export
    script carries into the port."""
    dataset = "coco"
    data_root = "data_local/mini_coco"
    load_anno = True
    max_epochs = 100
    eval_interval = 10
    save_interval = 25.0
    print_iter = 32


class SAVOCFile64(SASynthetic64):
    """`configs/sa_voc_file-res64.py`: the repo's trained SA on its
    generated VOC tree (`gen_mini_seg_data.py --voc 128 --res 96`), 200
    epochs; checkpoint `checkpoint/sa_voc_file-res64/ckpt_final`."""
    dataset = "voc"
    data_root = "data_local/mini_voc"
    load_anno = True
    max_epochs = 200
    eval_interval = 20
    save_interval = 50.0
    print_iter = 30


class SASyntheticCOCO64(SASynthetic64):
    """`configs/sa_synthetic_coco-res64.py`: SA under the dual inst/sem
    protocol on the COCO-shaped synthetic images (64 val)."""
    dataset = "synthetic_coco"
    val_samples = 64
    load_anno = True



# ---- the video-prediction and VQA stage ----------------------------------


class SAViLDMSyntheticLong3_64(SAViLDMMoviFile64):
    """The extraction model of the repo's synthetic video-prediction chain:
    an own copy of the JAX package's `configs/savi_ldm_synthetic_long3-
    res64.py` (over `savi_ldm_synthetic_long-res64.py` and
    `savi_ldm_synthetic_params-res64.py`), whose checkpoint
    `checkpoint/savi_ldm_synthetic_long3-res64/ckpt_final` the export
    script carries into the port (`--model savi_ldm_long3`). The model is
    `SAViLDMMoviFile64`'s; synthetic 64x64 clips of 2 frames (512 train,
    32 val), 8 a step, 320 epochs. `scripts/extract_slots_torch.py
    --seq_len 8` extracts 8-frame videos from it, as the JAX chain did."""
    max_epochs = 320
    save_interval = 16.0
    eval_interval = 8
    print_iter = 64
    dataset = "synthetic_video"
    data_root = ""
    train_samples = 512
    val_samples = 32
    max_objects = 4
    num_workers = 2


class SAViLDMPhysion128(SAViLDMMoviE128):
    """SAViDiffusion on Physion at 128x128 (`configs/video_based/savi_ldm/
    savi_ldm_physion_params-res128.py`): the flagship's model with 8 slots
    of 192, Physion's `training` subset (videos of 150 frames), 48 clips a
    step, 10 epochs. Its slots feed `LDMSlotFormerPhysion128`."""
    max_epochs = 10
    save_interval = 0.05
    dataset = "physion_training"
    data_root = "./data/Physion"
    tasks = ["all"]
    video_len = 150
    load_mask = False
    train_batch_size = 48
    val_batch_size = 96
    slot_dict = slot_dict_for(8, 192, 2)


class VQVAEPhysion128(VQVAEMoviE128):
    """SAViLDMPhysion128's stage 1 (`configs/video_based/savi_ldm/
    vqvae_physion_params-res128.py`): the flagship's VQ-VAE on single
    Physion frames, Adam at 5e-4, 20 epochs."""
    max_epochs = 20
    save_interval = 0.25
    eval_interval = 1
    lr = 5e-4
    dataset = "physion_training"
    data_root = "./data/Physion"
    tasks = ["all"]
    video_len = 150


class _SlotStage(BaseParams):
    """What the configs of the video-prediction stage share: the JAX
    `_Common` and the port trainer's defaults."""
    seed = 0
    min_lr = 0.0
    grad_accum_steps = 1
    use_ema = False
    ema_decay = 0.9999
    print_iter = 50
    use_bf16 = False
    weight_decay = 0.0
    num_workers = 8
    resolution = (128, 128)
    data_root = ""


class SlotFormerSynthetic(_SlotStage):
    """The repo's trained SlotFormer (`configs/slotformer_synthetic_
    params.py`, checkpoint `checkpoint/slotformer_synthetic_params/
    ckpt_last`): synthetic trajectories of 6 slots x 64 over 10 frames
    (256 train, 32 val), 16 a step, 2 epochs; a 2-layer pre-norm
    rollouter of 64 wide, 4 heads, sine temporal PE, history 6, rollout
    4, no decoder; the loss decay over the first 40 % of the steps."""
    max_epochs = 2
    save_interval = 1.0
    eval_interval = 1
    print_iter = 10
    lr = 2e-4
    clip_grad = -1
    warmup_steps_pct = 0.05
    dataset = "synthetic_slots"
    train_samples = 256
    val_samples = 32
    video_len = 10
    n_sample_frames = 10
    train_batch_size = 16
    val_batch_size = 16
    num_workers = 2
    model = "SlotFormer"
    resolution = (64, 64)
    slot_size = 64
    num_slots = 6
    slot_dict = dict(num_slots=6, slot_size=64)
    dec_dict = dict()
    rollout_dict = dict(num_slots=6, slot_size=64, history_len=6, t_pe="sin",
                        slots_pe="", d_model=64, num_layers=2, num_heads=4,
                        ffn_dim=256, norm_first=True)
    loss_dict = dict(rollout_len=4, use_img_recon_loss=False)
    slot_recon_loss_w = 1.0
    use_loss_decay = True
    loss_decay_pct = 0.4


class LDMSlotFormerSynthetic64(SlotFormerSynthetic):
    """The repo's trained LDMSlotFormer (`configs/ldmslotformer_synthetic_
    params-res64.py`, checkpoint `checkpoint/ldmslotformer_synthetic_
    params-res64/ckpt_final`): the slots `SAViLDMMoviFile64`'s model
    extracted from 8-frame synthetic videos (`slots_root`), 16 clips a
    step, 3 epochs; a 2-layer rollouter of 64, history 4, rollout 4; the
    frozen LDM is `SAViLDMMoviFile64`'s decoder (the plain GN and
    attention, as that config keeps them). `dec_dict["dm_ckp_path"]`
    names the port-format SAViDiffusion file it is grafted from (raw
    parameters); unset here, `scripts/train_torch.py --dm_ckp_path`
    sets it."""
    max_epochs = 3
    dataset = "synthetic_video_slots"
    slots_root = ("checkpoint/savi_ldm_synthetic_params-res64/"
                  "slots_synthetic.pkl")
    max_objects = 4
    video_len = 8
    n_sample_frames = 8
    model = "LDMSlotFormer"
    input_frames = 4
    rollout_dict = dict(SlotFormerSynthetic.rollout_dict, history_len=4)
    dec_dict = dict(SAViLDMMoviFile64.dec_dict, use_ema=False,
                    dm_ckp_path="")
    use_dpm = True


class LDMSlotFormerSynthetic64Long2(LDMSlotFormerSynthetic64):
    """`configs/ldmslotformer_synthetic_long2-res64.py`: the slots and the
    decoder of the savi_ldm long2 run (`checkpoint/
    ldmslotformer_synthetic_long2-res64/ckpt_final`)."""
    slots_root = ("checkpoint/savi_ldm_synthetic_long2-res64/"
                  "slots_synthetic.pkl")


class LDMSlotFormerSynthetic64Long3(LDMSlotFormerSynthetic64Long2):
    """`configs/ldmslotformer_synthetic_long3-res64.py`: the slots and the
    decoder of the savi_ldm long3 run (`SAViLDMSyntheticLong3_64`;
    checkpoint `checkpoint/ldmslotformer_synthetic_long3-res64/
    ckpt_final`), whose rollouts `ReadoutSyntheticRolloutLong` reads."""
    slots_root = ("checkpoint/savi_ldm_synthetic_long3-res64/"
                  "slots_synthetic.pkl")


class LDMSlotFormerPhysion128(_SlotStage):
    """LDMSlotFormer on Physion slots at 128x128 (`configs/vp_vqa/
    ldmslotformer_physion_params-res128.py`): clips of 15 + 10 slot
    frames 3 apart (`frame_offset`) of 150-frame videos, 128 a step, 25
    epochs; a 12-layer pre-norm rollouter of 256 wide, 8 heads, FFN 1024,
    sine temporal PE, history 15, rollout 10, over `SAViLDMPhysion128`'s 8
    slots of 192; its frozen LDM (the flagship's, with the GN and
    attention kernels). `dm_ckp_path` (the SAViLDMPhysion128 file, raw
    parameters) is unset: the JAX config's names an orbax directory."""
    max_epochs = 25
    save_interval = 0.125
    eval_interval = 2
    lr = 1e-4
    clip_grad = -1
    warmup_steps_pct = 0.05
    dataset = "physion_slots_training"
    data_root = "./data/Physion"
    slots_root = "./data/Physion/slots/physion_training_slots.pkl"
    tasks = ["all"]
    n_sample_frames = 15 + 10
    frame_offset = 3
    video_len = 150
    train_batch_size = 128
    val_batch_size = 256
    model = "LDMSlotFormer"
    input_frames = 15
    slot_size = 192
    num_slots = 8
    slot_dict = dict(num_slots=8, slot_size=192, slot_mlp_size=384,
                     num_iterations=2)
    rollout_dict = dict(num_slots=8, slot_size=192, history_len=15,
                        t_pe="sin", slots_pe="", d_model=256, num_layers=12,
                        num_heads=8, ffn_dim=256 * 4, norm_first=True)
    dec_dict = dict(ldm_dec_dict((128, 128), 192), use_ema=False,
                    dm_ckp_path="")
    loss_dict = dict(rollout_len=10, use_img_recon_loss=False)
    slot_recon_loss_w = 1.0


class ReadoutSynthetic(_SlotStage):
    """The repo's trained readout (`configs/readout_synthetic_params.py`,
    checkpoint `checkpoint/readout_synthetic_params/ckpt_last`): labelled
    synthetic trajectories of 6 slots x 64 over 10 frames, 16 a step, 2
    epochs, Adam at 1e-3 without warmup; max over the slot pairs."""
    max_epochs = 2
    save_interval = 1.0
    eval_interval = 1
    print_iter = 10
    lr = 1e-3
    clip_grad = -1
    warmup_steps_pct = 0.0
    dataset = "synthetic_slots"
    with_labels = True
    train_samples = 256
    val_samples = 32
    video_len = 10
    n_sample_frames = 10
    train_batch_size = 16
    val_batch_size = 16
    num_workers = 2
    model = "PhysionReadout"
    resolution = (64, 64)
    slot_size = 64
    num_slots = 6
    readout_dict = dict(num_slots=6, slot_size=64, agg_func="max",
                        feats_dim=64)
    vqa_loss_w = 1.0


class ReadoutSyntheticRolloutLong(ReadoutSynthetic):
    """The repo's readout trained on rolled-out slots (`configs/
    readout_synthetic_rollout_long.py` over `readout_synthetic_rollout_
    params.py`, checkpoint `checkpoint/readout_synthetic_rollout_long/
    ckpt_final`): `LDMSlotFormerSynthetic64Long3`'s rollouts of 512 train
    and 256 val and test videos (`rollout_root`), labelled by the source
    videos' object counts, 32 a step, 200 epochs."""
    max_epochs = 200
    eval_interval = 10
    save_interval = 25.0
    print_iter = 64
    dataset = "synthetic_rollout_slots"
    with_labels = False
    rollout_root = ("checkpoint/ldmslotformer_synthetic_long3-res64/"
                    "rollout_slots_big.pkl")
    max_objects = 4
    train_batch_size = 32
    val_batch_size = 32


class ReadoutPhysion(_SlotStage):
    """The Physion VQA readout (`configs/vp_vqa/readout_physion_params.py`):
    rolled-out slots of 8 x 192 over 75 frames with the readout subset's
    labels, 64 a step, 50 epochs, Adam at 1e-3 without warmup; max over
    the slot pairs, 192 features."""
    max_epochs = 50
    save_interval = 1.0
    eval_interval = 2
    lr = 1e-3
    clip_grad = -1
    warmup_steps_pct = 0.0
    dataset = "physion_slots_label_readout"
    data_root = "./data/Physion"
    slots_root = "./data/Physion/slots/rollout-physion_readout_slots.pkl"
    tasks = ["all"]
    n_sample_frames = 6
    frame_offset = 1
    video_len = 75
    train_batch_size = 64
    val_batch_size = 128
    model = "PhysionReadout"
    slot_size = 192
    num_slots = 8
    readout_dict = dict(num_slots=8, slot_size=192, agg_func="max",
                        feats_dim=192)
    vqa_loss_w = 1.0

CONFIGS = {c.__name__: c for c in (
    SAViLDMMoviE128, SAViLDMMoviFile64, SAViLDMMoviD128,
    SAViLDMMoviSolid128, SAViLDMMoviTex128, VQVAEMoviE128, VQVAEMoviD128,
    VQVAEMoviSolid128, VQVAEMoviTex128, VQVAESynthetic64,
    VQVAESyntheticLPIPS64, SACLEVRTex128, SACelebA128, SALDMCLEVRTex128,
    SALDMCelebA128, VQVAECLEVRTex128, VQVAECelebA128, SASyntheticLong64,
    SALDMSyntheticLong64, SAViMoviE128, SAViMoviD128, SAViMoviSolid128,
    SAViMoviTex128, STEVEMoviE128, STEVEMoviD128, STEVEMoviSolid128,
    STEVEMoviTex128, DVAEMoviE128, DVAEMoviD128, DVAEMoviSolid128,
    DVAEMoviTex128, DVAECLEVRTex128, DVAECelebA128, SLATECLEVRTex128,
    SLATECelebA128, SAViSynthetic64, DVAESyntheticLong64,
    SLATESyntheticLong64, STEVESyntheticLong64, SALDMDINOCOCO224,
    SALDMDINOVOC224, VQVAECOCO224, VQVAEVOC224, SASynthetic64,
    SACOCOFile64, SAVOCFile64, SASyntheticCOCO64, SAViLDMSyntheticLong3_64,
    SAViLDMPhysion128, VQVAEPhysion128, SlotFormerSynthetic,
    LDMSlotFormerSynthetic64, LDMSlotFormerSynthetic64Long2,
    LDMSlotFormerSynthetic64Long3, LDMSlotFormerPhysion128,
    ReadoutSynthetic, ReadoutSyntheticRolloutLong, ReadoutPhysion)}


def get_config(name):
    """A config of the port by its class name."""
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r}: one of {sorted(CONFIGS)}")
    return CONFIGS[name]()
