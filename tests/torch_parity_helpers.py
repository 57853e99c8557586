"""Shared tiny configs and helpers for the PyTorch-port parity tests
(`tests/test_torch_*.py`): one seeded config goes through the JAX model
and, with its parameters carried across by `slotdiffusion_tpu_torch.
convert`, through the port on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np

from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.utils import BaseParams
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import convert_model
from slotdiffusion_tpu_torch.models import build_model as build_torch_model
from slotdiffusion_tpu_torch.models import is_video

RES = (16, 16)          # image; latents and ResNet features are 4x4
SLOTS, SLOT_SIZE = 3, 32
T_FRAMES = 2
TIMESTEPS = 50
# the whole-model gate of a bf16 output (tests/test_torch_bf16.py): |port16
# - jax16| <= WHOLE_C |jax16 - jax32| and ROUNDS[0] <= |port16 - port32| /
# |jax16 - jax32| <= ROUNDS[1]
WHOLE_C = 2.0
ROUNDS = (0.5, 2.0)


def tiny_config(use_pallas=True, use_bf16=False):
    """The flagship's structure at narrow widths
    (`slotdiffusion_tpu_torch.configs.tiny_config`)."""
    return configs.tiny_config(RES, SLOTS, SLOT_SIZE, TIMESTEPS, use_pallas,
                               use_bf16)


def jax_params_of(cfg):
    """BaseParams for the JAX package from the port's config (the JAX
    model reads the same nested dicts; it ignores `use_pallas` in
    slot_dict and resolves its own knobs)."""
    p = BaseParams()
    for k in ("model", "resolution", "enc_dict", "dec_dict", "pred_dict",
              "use_bf16", "dvae_dict", "vocab_size"):
        if hasattr(cfg, k):
            setattr(p, k, getattr(cfg, k))
    if hasattr(cfg, "slot_dict"):
        p.slot_dict = {k: v for k, v in cfg.slot_dict.items()
                       if k != "use_pallas"}
    p.loss_dict = getattr(cfg, "loss_dict", dict(use_denoise_loss=True))
    if is_video(cfg.model):
        p.n_sample_frames = T_FRAMES
    return p


def video(seed=0, B=1, T=T_FRAMES):
    return np.random.RandomState(seed).uniform(
        -1, 1, (B, T, *RES, 3)).astype(np.float32)


def random_params(shapes, seed=0):
    """Seeded numpy values for a flax param-shape tree: norm scales near 1,
    biases small, codebook entries U(-1, 1), kernels ~ N(0, 1/fan_in).
    Zero-initialized layers get random values too, so every layer is
    exercised (initializing through flax would compile the whole model,
    which takes ~30 s on the CPU)."""
    r = np.random.RandomState(seed)

    def fill(path, s):
        name = str(path[-1].key)
        if name == "embedding":
            v = r.uniform(-1, 1, s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * r.randn(*s.shape)
        elif name == "bias" or len(s.shape) == 1:
            v = 0.1 * r.randn(*s.shape)
        elif name == "init_latents":
            v = r.randn(*s.shape)
        else:
            fan_in = int(np.prod(s.shape[:-1]))
            v = r.randn(*s.shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def build_pair(use_pallas=True, seed=0, use_bf16=False, cfg=None):
    """-> (cfg, jax model, jax variables, port model on the CPU), both
    holding the same seeded (f32) weights and computing in bf16 under
    `use_bf16`; `cfg` (a video or an image model's) replaces the tiny
    config."""
    cfg = tiny_config(use_pallas, use_bf16) if cfg is None else cfg
    jmodel = build_jax_model(jax_params_of(cfg))
    rngs = {n: jax.random.PRNGKey(i) for i, n in enumerate(
        ("params", "diffusion", "dropout", "gumbel"))}
    x = video() if is_video(cfg.model) else images()
    shapes = jax.eval_shape(
        lambda r, x: jmodel.init(r, {"img": x}, method=jmodel.compute_losses),
        rngs, jnp.asarray(x))
    params = random_params(shapes["params"], seed)
    tmodel = build_torch_model(cfg, device="cpu")
    missing, unexpected = tmodel.load_state_dict(
        convert_model(params, cfg), strict=True)
    assert not missing and not unexpected
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    return cfg, jmodel, jvars, tmodel


def t2n(x):
    return x.detach().cpu().numpy()


# ---- the image family (tests/test_torch_images.py) -----------------------

IMG_ITERS = 3
IMG_TIMESTEPS = 10  # DDIM takes min(200, T) steps: 10 keep it cheap


def tiny_image_config(model="SADiffusion", use_pallas=False):
    """The image configs' structure at narrow widths, 16x16, 3 slots of 32
    over 3 iterations. SADiffusion: the GN-ResNet18 encoder (4x4
    features, so eval masks are upsampled) and the tiny flagship's LDM
    (4x4x3 latents, 10 timesteps); SA: the plain CNN encoder (3 -> 16 ->
    16, 5x5, as the trained SA's) and the spatial broadcast decoder 32 ->
    16 x 3 from 4x4 (two stride-2 deconvs, then one of stride 1)."""
    base = configs.SALDMCLEVRTex128 if model == "SADiffusion" else \
        configs.SACLEVRTex128
    video = configs.tiny_config(RES, SLOTS, SLOT_SIZE, IMG_TIMESTEPS)
    cfg = base().copy(
        resolution=RES, train_batch_size=2, val_batch_size=2,
        dataset="synthetic", train_samples=4, val_samples=4,
        slot_dict=configs.slot_dict_for(SLOTS, SLOT_SIZE, IMG_ITERS,
                                        use_pallas))
    if model == "SADiffusion":
        cfg.enc_dict = dict(video.enc_dict)
        cfg.dec_dict = video.dec_dict
    else:
        cfg.enc_dict = dict(enc_channels=(3, 16, 16), enc_ks=5,
                            enc_out_channels=SLOT_SIZE, enc_norm="")
        cfg.dec_dict = dict(dec_channels=(SLOT_SIZE, 16, 16, 16),
                            dec_resolution=(4, 4), dec_ks=5, dec_norm="")
    return cfg


def images(seed=0, B=2):
    return np.random.RandomState(seed).uniform(
        -1, 1, (B, *RES, 3)).astype(np.float32)


def jax_sad_loss(m, img, t, noise):
    """The JAX SADiffusion's denoising loss at fixed timesteps and latent
    noise (`m.apply(..., method=jax_sad_loss)`): q_sample + denoise
    composed here, as `make_rng` draws can never equal a torch
    Generator's."""
    out = m({"img": img}, train=True)
    dm = m.dm_decoder
    pred = dm.denoise(dm.q_sample(dm.encode_latent(img), t, noise), t,
                      context=out["slots"], train=False)
    return jnp.mean((pred - noise) ** 2)


# ---- the token and reconstruction baselines (tests/test_torch_baselines*) --

VOCAB = 16  # the tiny dVAE's tokens; 16x16 images give 4x4 of them
TINY_PRED = dict(pred_type="transformer", pred_rnn=False,
                 pred_norm_first=True, pred_num_layers=1, pred_num_heads=2,
                 pred_ffn_dim=2 * SLOT_SIZE, pred_sg_every=None)


def tiny_baseline_config(model, use_pallas=False, pred_dict=None,
                         img_recon=False):
    """The baseline configs' structure at narrow widths, 16x16, 3 slots of
    32, 2 iterations (3 for SLATE, as its configs). SAVi: the plain CNN
    encoder (3 -> 16 -> 16) and the spatial broadcast decoder 32 -> 16 x 3
    from 4x4; STEVE: the GN-ResNet18 encoder (4x4 features and masks), a
    1-layer transformer predictor; SLATE: the plain CNN encoder (16x16
    masks); both a dVAE of `VOCAB` tokens (4x4 of them) and a 2-block AR
    decoder of 32 with 2 heads, STEVE's pixel loss with `img_recon`; the
    dVAE ("dVAE") alone with `VOCAB` tokens. `pred_dict` replaces the
    1-layer transformer predictor."""
    cnn = dict(enc_channels=(3, 16, 16), enc_ks=5,
               enc_out_channels=SLOT_SIZE, enc_norm="")
    token = dict(dvae_dict=dict(down_factor=4, vocab_size=VOCAB),
                 dec_dict=dict(dec_num_layers=2, dec_num_heads=2,
                               dec_d_model=SLOT_SIZE))
    common = dict(resolution=RES, train_batch_size=2, val_batch_size=2,
                  train_samples=4, val_samples=4)
    if model == "dVAE":
        return configs.DVAEMoviE128().copy(
            vocab_size=VOCAB, dvae_dict=token["dvae_dict"],
            dataset="synthetic_video", **common)
    slot = configs.slot_dict_for(SLOTS, SLOT_SIZE,
                                 3 if model == "SLATE" else 2, use_pallas)
    pred = dict(TINY_PRED if pred_dict is None else pred_dict)
    if model == "SAVi":
        return configs.SAViMoviE128().copy(
            slot_dict=slot, enc_dict=cnn, pred_dict=pred,
            dec_dict=dict(dec_channels=(SLOT_SIZE, 16, 16, 16),
                          dec_resolution=(4, 4), dec_ks=5, dec_norm=""),
            n_sample_frames=T_FRAMES, dataset="synthetic_video", **common)
    if model == "STEVE":
        return configs.STEVEMoviE128().copy(
            slot_dict=slot, pred_dict=pred, n_sample_frames=T_FRAMES,
            enc_dict=dict(configs.STEVEMoviE128.enc_dict,
                          enc_out_channels=SLOT_SIZE),
            loss_dict=dict(use_img_recon_loss=img_recon),
            dataset="synthetic_video", **token, **common)
    return configs.SLATECLEVRTex128().copy(
        slot_dict=slot, enc_dict=cnn, dataset="synthetic", **token,
        **common)
