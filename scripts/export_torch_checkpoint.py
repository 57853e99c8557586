"""Carry a JAX trainer checkpoint (orbax) into the PyTorch port: restore
it with the JAX package, convert its parameters to the port's names and
layouts (`slotdiffusion_tpu_torch.convert`), and write one port-format
file that `training/checkpoint.py:load_checkpoint` and `graft_pretrained`
read: {"model": state_dict, "config": name, "source": path, "ema": bool}.

    # the repo's trained SAViDiffusion, with the EMA of dm_decoder
    python scripts/export_torch_checkpoint.py
    # the repo's trained image models: SA, and SADiffusion (its EMA of
    # dm_decoder swapped in)
    python scripts/export_torch_checkpoint.py --model sa
    python scripts/export_torch_checkpoint.py --model sa_ldm
    # the repo's trained baselines: SAVi, the dVAE (which SLATE and STEVE
    # ran against; train_torch.py's SLATESyntheticLong64 and
    # STEVESyntheticLong64 take this file), SLATE and STEVE
    python scripts/export_torch_checkpoint.py --model savi
    python scripts/export_torch_checkpoint.py --model dvae
    python scripts/export_torch_checkpoint.py --model slate
    python scripts/export_torch_checkpoint.py --model steve
    # the repo's SA trained on its generated COCO and VOC trees
    python scripts/export_torch_checkpoint.py --model sa_coco
    python scripts/export_torch_checkpoint.py --model sa_voc
    # the synthetic video-prediction chain: the extraction model (its raw
    # dm_decoder, which LDMSlotFormerSynthetic64Long3 grafts), SlotFormer,
    # LDMSlotFormer (long2, long3) and the two readouts
    python scripts/export_torch_checkpoint.py --model savi_ldm_long3
    python scripts/export_torch_checkpoint.py --model slotformer
    python scripts/export_torch_checkpoint.py --model ldmslotformer_long3
    python scripts/export_torch_checkpoint.py --model readout
    python scripts/export_torch_checkpoint.py --model readout_rollout_long
    # a stand-alone stage-1 VQ-VAE run (default: vqvae_synthetic_params-
    # res64's ckpt_last), for the port's VQVAE configs and for
    # train_torch.py --vqvae_ckp_path
    python scripts/export_torch_checkpoint.py --vqvae
    python scripts/export_torch_checkpoint.py --vqvae \
        --params configs/vqvae_synthetic_lpips-res64.py \
        --weight checkpoint/vqvae_synthetic_lpips-res64/ckpt_final \
        --out checkpoint/torch_vqvae_synthetic_lpips-res64/vqvae.pt

This script imports JAX and orbax, so it runs where the JAX package runs,
not on the card machine. The outputs go under `checkpoint/torch_*/`
(git-ignored) unless `--out` names another file.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (JAX config, checkpoint, output) of each trained model in the repo
DEFAULTS = {
    "savi_ldm": ("configs/savi_ldm_movi_file-res64.py",
                 "checkpoint/savi_ldm_movi_file-res64/ckpt_final",
                 "checkpoint/torch_savi_ldm_movi_file-res64/model.pt"),
    "vqvae": ("configs/vqvae_synthetic_params-res64.py",
              "checkpoint/vqvae_synthetic_params-res64/ckpt_last",
              "checkpoint/torch_vqvae_synthetic_params-res64/vqvae.pt"),
    "sa": ("configs/sa_synthetic_long-res64.py",
           "checkpoint/sa_synthetic_long-res64/ckpt_final",
           "checkpoint/torch_sa_synthetic_long-res64/model.pt"),
    "sa_ldm": ("configs/sa_ldm_synthetic_long-res64.py",
               "checkpoint/sa_ldm_synthetic_long-res64/ckpt_final",
               "checkpoint/torch_sa_ldm_synthetic_long-res64/model.pt"),
    "savi": ("configs/savi_synthetic_params-res64.py",
             "checkpoint/savi_synthetic_params-res64/ckpt_last",
             "checkpoint/torch_savi_synthetic_params-res64/model.pt"),
    "dvae": ("configs/dvae_synthetic_long-res64.py",
             "checkpoint/dvae_synthetic_long-res64/ckpt_final",
             "checkpoint/torch_dvae_synthetic_long-res64/dvae.pt"),
    "slate": ("configs/slate_synthetic_long-res64.py",
              "checkpoint/slate_synthetic_long-res64/ckpt_final",
              "checkpoint/torch_slate_synthetic_long-res64/model.pt"),
    "steve": ("configs/steve_synthetic_long-res64.py",
              "checkpoint/steve_synthetic_long-res64/ckpt_final",
              "checkpoint/torch_steve_synthetic_long-res64/model.pt"),
    "sa_coco": ("configs/sa_coco_file-res64.py",
                "checkpoint/sa_coco_file-res64/ckpt_final",
                "checkpoint/torch_sa_coco_file-res64/model.pt"),
    "sa_voc": ("configs/sa_voc_file-res64.py",
               "checkpoint/sa_voc_file-res64/ckpt_final",
               "checkpoint/torch_sa_voc_file-res64/model.pt"),
    "savi_ldm_long3": ("configs/savi_ldm_synthetic_long3-res64.py",
                       "checkpoint/savi_ldm_synthetic_long3-res64/ckpt_final",
                       "checkpoint/torch_savi_ldm_synthetic_long3-res64/"
                       "model.pt"),
    "slotformer": ("configs/slotformer_synthetic_params.py",
                   "checkpoint/slotformer_synthetic_params/ckpt_last",
                   "checkpoint/torch_slotformer_synthetic_params/model.pt"),
    # (not the params run: its checkpoint holds the VQ-VAE under flax's
    # old automatic names, Conv_0, ResnetBlock_0, ..., which the JAX
    # package cannot apply either)
    **{f"ldmslotformer_{run}": (
        f"configs/ldmslotformer_synthetic_{run}-res64.py",
        f"checkpoint/ldmslotformer_synthetic_{run}-res64/ckpt_final",
        f"checkpoint/torch_ldmslotformer_synthetic_{run}-res64/model.pt")
       for run in ("long2", "long3")},
    "readout": ("configs/readout_synthetic_params.py",
                "checkpoint/readout_synthetic_params/ckpt_last",
                "checkpoint/torch_readout_synthetic_params/model.pt"),
    "readout_rollout_long": (
        "configs/readout_synthetic_rollout_long.py",
        "checkpoint/readout_synthetic_rollout_long/ckpt_final",
        "checkpoint/torch_readout_synthetic_rollout_long/model.pt"),
}
# exported with the raw dm_decoder whatever --no_ema says: the savi_ldm
# long3 file is what LDMSlotFormerSynthetic64Long3 grafts (the raw
# parameters, as the JAX `apply_pretrained` grafts) and what
# extract_slots_torch.py encodes with (which reads no decoder)
RAW = ("savi_ldm_long3",)
# the port's config of each JAX config file
PORT_CONFIGS = {"savi_ldm_movi_file-res64": "SAViLDMMoviFile64",
                "vqvae_synthetic_params-res64": "VQVAESynthetic64",
                "vqvae_synthetic_lpips-res64": "VQVAESyntheticLPIPS64",
                "sa_synthetic_long-res64": "SASyntheticLong64",
                "sa_ldm_synthetic_long-res64": "SALDMSyntheticLong64",
                "savi_synthetic_params-res64": "SAViSynthetic64",
                "dvae_synthetic_long-res64": "DVAESyntheticLong64",
                "slate_synthetic_long-res64": "SLATESyntheticLong64",
                "steve_synthetic_long-res64": "STEVESyntheticLong64",
                "sa_coco_file-res64": "SACOCOFile64",
                "sa_voc_file-res64": "SAVOCFile64",
                "savi_ldm_synthetic_long3-res64": "SAViLDMSyntheticLong3_64",
                "slotformer_synthetic_params": "SlotFormerSynthetic",
                "ldmslotformer_synthetic_params-res64":
                    "LDMSlotFormerSynthetic64",
                "ldmslotformer_synthetic_long2-res64":
                    "LDMSlotFormerSynthetic64Long2",
                "ldmslotformer_synthetic_long3-res64":
                    "LDMSlotFormerSynthetic64Long3",
                "readout_synthetic_params": "ReadoutSynthetic",
                "readout_synthetic_rollout_long":
                    "ReadoutSyntheticRolloutLong"}


def export(params_path, weight, out, config=None, use_ema=True,
           vqvae=False):
    """Restore `weight` (built by the JAX config `params_path`), convert
    it (SAViDiffusion, SADiffusion, SA, SAVi, the dVAE, SLATE, STEVE,
    SlotFormer, LDMSlotFormer, the readout) and write `out`; -> the
    written
    dict. `config` is the port's name of the model's config (default:
    the `PORT_CONFIGS` entry of the JAX file, else SAViLDMMoviFile64).
    With `vqvae` the checkpoint is a stand-alone VQVAE run (its tree's
    root is the VQVAE), and the default name is the JAX file's when
    `PORT_CONFIGS` has none. `use_ema` swaps in the checkpoint's EMA of
    dm_decoder, where the model keeps one."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from slotdiffusion_tpu.models import build_model
    from slotdiffusion_tpu.training.checkpoint import load_model_params
    from slotdiffusion_tpu.utils import load_params
    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.convert import (convert_model,
                                                 convert_vqvae_state_dict)
    from slotdiffusion_tpu_torch.training.checkpoint import save_checkpoint

    jparams = load_params(params_path)
    model = build_model(jparams)
    variables = load_model_params(model, weight, jparams, use_ema=use_ema)
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    stem = os.path.splitext(os.path.basename(params_path))[0]
    if vqvae:
        sd = convert_vqvae_state_dict(tree, jparams.enc_dec_dict)
        name = config or PORT_CONFIGS.get(stem, stem)
        use_ema = False
    else:
        name = config or PORT_CONFIGS.get(stem, "SAViLDMMoviFile64")
        cfg = configs.get_config(name)
        sd = convert_model(tree, cfg)
        use_ema = use_ema and bool(
            (getattr(cfg, "dec_dict", None) or {}).get("use_ema", False))
    state = {"model": sd, "config": name, "source": weight,
             "ema": bool(use_ema)}
    save_checkpoint(out, state)
    return state


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="savi_ldm",
                        choices=sorted(DEFAULTS),
                        help="whose defaults (JAX config, checkpoint, "
                             "output) to take")
    parser.add_argument("--vqvae", action="store_true",
                        help="export the stage-1 VQ-VAE alone (the "
                             "defaults of --model vqvae)")
    parser.add_argument("--params", default="",
                        help="the JAX config file the checkpoint trained")
    parser.add_argument("--weight", default="",
                        help="the orbax checkpoint directory")
    parser.add_argument("--config", default=None,
                        help="the port's config of the model (default: "
                             "the port's name of the JAX config)")
    parser.add_argument("--out", default="", help="the .pt to write")
    parser.add_argument("--no_ema", action="store_true",
                        help="keep the raw dm_decoder, not its EMA")
    args = parser.parse_args(argv)
    what = "vqvae" if args.vqvae else args.model
    params_path, weight, out = DEFAULTS[what]
    params_path = args.params or os.path.join(REPO, params_path)
    weight = args.weight or os.path.join(REPO, weight)
    out = args.out or os.path.join(REPO, out)
    state = export(params_path, weight, out, args.config,
                   use_ema=not args.no_ema and what not in RAW,
                   vqvae=what == "vqvae")
    n = sum(v.numel() for v in state["model"].values())
    print(f"wrote {out}: {len(state['model'])} tensors, {n} parameters, "
          f"config {state['config']}, ema {state['ema']}, from {weight}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
