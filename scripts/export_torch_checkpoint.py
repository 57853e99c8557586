"""Carry a JAX trainer checkpoint (orbax) into the PyTorch port: restore
it with the JAX package, convert its parameters to the port's names and
layouts (`slotdiffusion_tpu_torch.convert`), and write one port-format
file that `training/checkpoint.py:load_checkpoint` and `graft_pretrained`
read: {"model": state_dict, "config": name, "source": path, "ema": bool}.

    # the repo's trained SAViDiffusion, with the EMA of dm_decoder
    python scripts/export_torch_checkpoint.py
    # its frozen stage-1 VQ-VAE alone (for train_torch.py --vqvae_ckp_path)
    python scripts/export_torch_checkpoint.py --vqvae

This script imports JAX and orbax, so it runs where the JAX package runs,
not on the card machine. The outputs go under `checkpoint/torch_*/`
(git-ignored) unless `--out` names another file.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEFAULTS = {
    False: ("configs/savi_ldm_movi_file-res64.py",
            "checkpoint/savi_ldm_movi_file-res64/ckpt_final",
            "checkpoint/torch_savi_ldm_movi_file-res64/model.pt"),
    True: ("configs/vqvae_synthetic_params-res64.py",
           "checkpoint/vqvae_synthetic_params-res64/ckpt_last",
           "checkpoint/torch_vqvae_synthetic_params-res64/vqvae.pt"),
}


def export(params_path, weight, out, config="SAViLDMMoviFile64",
           use_ema=True, vqvae=False):
    """Restore `weight` (built by the JAX config `params_path`), convert
    it and write `out`; -> the written dict."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from slotdiffusion_tpu.models import build_model
    from slotdiffusion_tpu.training.checkpoint import load_model_params
    from slotdiffusion_tpu.utils import load_params
    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.convert import (convert_savi_diffusion,
                                                 convert_vqvae)
    from slotdiffusion_tpu_torch.training.checkpoint import save_checkpoint

    jparams = load_params(params_path)
    model = build_model(jparams)
    variables = load_model_params(model, weight, jparams, use_ema=use_ema)
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    if vqvae:
        sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
              convert_vqvae(tree, jparams.enc_dec_dict).items()}
        name = os.path.splitext(os.path.basename(params_path))[0]
        use_ema = False
    else:
        sd = convert_savi_diffusion(tree, configs.get_config(config))
        name = config
    state = {"model": sd, "config": name, "source": weight,
             "ema": bool(use_ema)}
    save_checkpoint(out, state)
    return state


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--vqvae", action="store_true",
                        help="export the stage-1 VQ-VAE alone")
    parser.add_argument("--params", default="",
                        help="the JAX config file the checkpoint trained")
    parser.add_argument("--weight", default="",
                        help="the orbax checkpoint directory")
    parser.add_argument("--config", default="SAViLDMMoviFile64",
                        help="the port's config of the model")
    parser.add_argument("--out", default="", help="the .pt to write")
    parser.add_argument("--no_ema", action="store_true",
                        help="keep the raw dm_decoder, not its EMA")
    args = parser.parse_args(argv)
    params_path, weight, out = DEFAULTS[args.vqvae]
    params_path = args.params or os.path.join(REPO, params_path)
    weight = args.weight or os.path.join(REPO, weight)
    out = args.out or os.path.join(REPO, out)
    state = export(params_path, weight, out, args.config,
                   use_ema=not args.no_ema, vqvae=args.vqvae)
    n = sum(v.numel() for v in state["model"].values())
    print(f"wrote {out}: {len(state['model'])} tensors, {n} parameters, "
          f"config {state['config']}, ema {state['ema']}, from {weight}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
