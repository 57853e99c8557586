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
from slotdiffusion_tpu_torch.convert import convert_savi_diffusion
from slotdiffusion_tpu_torch.models import build_model as build_torch_model

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
              "use_bf16"):
        setattr(p, k, getattr(cfg, k))
    p.slot_dict = {k: v for k, v in cfg.slot_dict.items()
                   if k != "use_pallas"}
    p.loss_dict = dict(use_denoise_loss=True)
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


def build_pair(use_pallas=True, seed=0, use_bf16=False):
    """-> (cfg, jax model, jax variables, port model on the CPU), both
    holding the same seeded (f32) weights and computing in bf16 under
    `use_bf16`."""
    cfg = tiny_config(use_pallas, use_bf16)
    jmodel = build_jax_model(jax_params_of(cfg))
    rngs = {n: jax.random.PRNGKey(i) for i, n in enumerate(
        ("params", "diffusion", "dropout"))}
    shapes = jax.eval_shape(
        lambda r, x: jmodel.init(r, {"img": x}, method=jmodel.compute_losses),
        rngs, jnp.asarray(video()))
    params = random_params(shapes["params"], seed)
    tmodel = build_torch_model(cfg, device="cpu")
    missing, unexpected = tmodel.load_state_dict(
        convert_savi_diffusion(params, cfg), strict=True)
    assert not missing and not unexpected
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    return cfg, jmodel, jvars, tmodel


def t2n(x):
    return x.detach().cpu().numpy()
