"""Export a serving surface of the PyTorch port to an artifact file (the
counterpart of scripts/export_model.py).

    python scripts/export_model_torch.py --params SAViLDMMoviE128 \
        [--weight <port .pt>] --what encode|sample|denoise --bs 2 \
        --out exports/encode.pt2 [--check] [--bf16] [--cpu]
    python scripts/export_model_torch.py --params SALDMCLEVRTex128 \
        --what encode --bs 8 --out exports/img_encode.pt2   # images

The artifact reloads with `torch` and the port's `ops` package alone (no
model class, no config), on a device it was exported for:

    from slotdiffusion_tpu_torch.serving import load_artifact
    call, header = load_artifact("exports/encode.pt2")
    slots, masks = call(video)          # [B, T, H, W, 3] float32
    slots, masks = call(images)         # an image model's: [B, H, W, 3]

It traces on the CUDA card unless `--cpu` is given, and exits with an
error when there is no card and no `--cpu`. `--devices cuda cpu` (the JAX
script's `--platforms`) writes one program set per device from that one
trace, so a host without a card exports for the card:

    python scripts/export_model_torch.py --params SAViLDMMoviE128 \
        --what encode --out exports/encode.pt2 --cpu --devices cuda cpu
    call, header = load_artifact("exports/encode.pt2", "cuda")  # a card

Without `--weight` it exports random weights made from seed 0 and says
so. `--check` reloads the artifact on a device it holds that is here and
runs it on zeros, printing the output shapes and dtypes.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--params", required=True,
                        help="a port config (slotdiffusion_tpu_torch."
                             "configs)")
    parser.add_argument("--weight", default=None,
                        help="a port-format checkpoint (.pt); omit for "
                             "random weights from seed 0")
    parser.add_argument("--what", default="encode",
                        choices=("encode", "sample", "denoise"))
    parser.add_argument("--bs", type=int, default=2,
                        help="videos (or images) a request")
    parser.add_argument("--out", required=True)
    parser.add_argument("--bf16", action="store_true",
                        help="the model in bf16 (use_bf16)")
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="trace on the CPU")
    parser.add_argument("--devices", nargs="+", choices=("cuda", "cpu"),
                        help="the devices to write programs for (default: "
                             "the tracing device)")
    args = parser.parse_args(argv)

    import torch

    from slotdiffusion_tpu_torch import configs, serving
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.training.checkpoint import \
        load_model_weights

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to export for the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    params = configs.get_config(args.params)
    params.use_bf16 = args.bf16
    model = build_model(params, device=device)
    if args.weight:
        load_model_weights(model, args.weight)
    else:
        init_random_(model, torch.Generator().manual_seed(0))
        print("WARNING: no --weight, exporting random weights (seed 0)",
              flush=True)
    fn, example = serving.build_serving_fn(
        model, args.what, serving.data_shape(params, args.bs),
        graphed=False)
    t = time.perf_counter()
    header = serving.save_artifact(
        args.out, fn, example, devices=args.devices,
        meta={"params": args.params, "what": args.what,
              "weight": args.weight or "random (seed 0)",
              "bf16": args.bf16})
    print(f"exported {args.what} -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t:.1f} s for "
          f"{', '.join(header['devices'])}, args "
          f"{header['args']}", flush=True)

    if args.check:
        here = [d for d in header["devices"]
                if d == "cpu" or torch.cuda.is_available()]
        if not here:
            print("check skipped: no device the artifact is for is here",
                  flush=True)
            return
        call, header = serving.load_artifact(args.out, here[0])
        outs = call(*[torch.zeros(a["shape"], dtype=getattr(torch,
                                                            a["dtype"]))
                      for a in header["args"]])
        outs = outs if isinstance(outs, tuple) else (outs,)
        print(f"check OK on {here[0]}: outputs " + ", ".join(
            f"{tuple(o.shape)} {str(o.dtype).removeprefix('torch.')}"
            for o in outs), flush=True)


if __name__ == "__main__":
    main()
