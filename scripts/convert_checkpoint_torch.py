"""Convert checkpoints between the reference's torch layout (the original
SlotDiffusion `.pth` files) and the PyTorch port, both directions (the
counterpart of scripts/convert_checkpoint.py for
`slotdiffusion_tpu_torch`).

    # reference -> port: a published .pth, written as a port-format file
    # ({"model", "config", "source", "ema"}, as
    # scripts/export_torch_checkpoint.py writes) that the port's scripts
    # take as --weight
    python scripts/convert_checkpoint_torch.py --params SAViLDMMoviE128 \
        --weight savi_ldm_movie.pth --out checkpoint/torch_ref/model.pt

    # port -> reference: {"state_dict": ...} from a port checkpoint (a
    # trainer's ckpt_last.pt or an exported model.pt); --use_ema swaps in
    # the EMA shadow a trainer's file keeps
    python scripts/convert_checkpoint_torch.py --params SAViLDMMoviE128 \
        --weight checkpoint/torch_savi_ldm_movie/ckpt_last.pt \
        --out savi_ldm_movie.pth --to_torch --use_ema

`--params` names a port config (`slotdiffusion_tpu_torch.configs`) of the
families the JAX converter dispatches: SA, SAVi, SADiffusion,
SAViDiffusion, SLATE, STEVE, VQVAE, the dVAE, SlotFormer, LDMSlotFormer,
PhysionReadout. A reference file is read with `weights_only=True`; its
`{"state_dict": ...}` wrapper, `module.` prefixes and `loss.` heads are
handled as the JAX converter does; a tensor the model lacks, one the
file lacks (but those the reference never carries: the frozen DINO ViT,
a rollouter's learnable PEs, which keep the model's values), or a shape
that differs stops the conversion with its name
(`slotdiffusion_tpu_torch.convert.load_reference_state_dict`). Only
torch is needed: the conversion runs on the CPU of any machine.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--params", required=True,
                        help="the port config of the model")
    parser.add_argument("--weight", required=True,
                        help="source: a reference .pth (default) or a "
                             "port checkpoint (--to_torch)")
    parser.add_argument("--out", required=True,
                        help="destination: a port-format .pt (default) or "
                             "a reference-layout .pth (--to_torch)")
    parser.add_argument("--to_torch", action="store_true",
                        help="port -> the reference's layout")
    parser.add_argument("--use_ema", action="store_true",
                        help="with --to_torch: the EMA shadow swapped in")
    args = parser.parse_args(argv)

    import torch

    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.convert import (
        export_reference_state_dict, load_reference_state_dict)
    from slotdiffusion_tpu_torch.models import build_model
    from slotdiffusion_tpu_torch.training.checkpoint import (
        load_checkpoint, save_checkpoint)

    cfg = configs.get_config(args.params)
    if args.to_torch:
        state = load_checkpoint(args.weight)
        sd = dict(state["model"])
        if args.use_ema and isinstance(state.get("ema"), dict):
            sd.update(state["ema"]["shadow"])
        ref = export_reference_state_dict(sd, cfg)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        torch.save({"state_dict": ref}, args.out)
        print(f"exported {len(ref)} tensors -> {args.out}", flush=True)
        return 0
    sd = torch.load(args.weight, map_location="cpu", weights_only=True)
    target = build_model(cfg, device="cpu").state_dict()
    model = load_reference_state_dict(sd, cfg, target)
    save_checkpoint(args.out, {"model": model, "config": args.params,
                               "source": args.weight, "ema": False})
    print(f"converted {len(model)} tensors -> {args.out} (config "
          f"{args.params})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
