"""The evaluation loops of the port's scripts, in the package so the
scripts, the tests and the card's smoke run share them:

- `recon_eval`: test_recon (the counterpart of the JAX package's
  scripts/test_recon.py:56-180): each batch encoded and decoded
  (`recon_samples`), scored by MSE, PSNR, SSIM and, when an LPIPS
  `.npz` exists, LPIPS under its provenance label; with FID / FVD the
  raw Inception / I3D features of both sides join the batch's results
  (`_fid`, `_fvd`, skipped by the meters), so a resumed run rebuilds the
  exact Frechet statistics. The results are cached per batch index and
  the cache rewritten after each batch: a batch already in it is not
  computed again (not even moved to the device).
- `comp_gen_eval`: compositional generation (scripts/test_comp_gen.py:
  97-170): encode, `shuffle_slots`, `decode_slots`, the composed frames
  written as PNGs numbered over the run, FID / FVD of the composed
  frames against the real ones.

Batch i draws its noise from a generator seeded with i, on the model's
device.
"""

import os

import torch

from ..ops import fid as fid_ops
from ..ops import fvd as fvd_ops
from ..ops import lpips as lpips_ops
from ..ops import metrics as M
from ..utils import AverageMeter, dump_obj, load_obj
from ..utils.png import save_image
from .comp_gen import DIFFUSION, TOKEN, decode_slots, encode_slots, \
    shuffle_slots

VIDEO = ("SAVi", "SAViDiffusion", "STEVE")


def feature_fns(fid=False, fvd=False,
                missing="WARNING: --{flag} needs {env}; skipping"):
    """(FID feature function or None, FVD feature function or None): frames
    or clips in [0, 1] -> numpy features, the networks of the files the
    environment names (`SLOTDIFFUSION_INCEPTION_WEIGHTS`,
    `SLOTDIFFUSION_I3D_WEIGHTS`), which the metrics' labels read too; one
    asked for whose file is missing prints `missing` and is None."""
    fns = []
    for wanted, mod, flag, feats in (
            (fid, fid_ops, "fid", fid_ops.inception_pool3_features),
            (fvd, fvd_ops, "fvd", fvd_ops.i3d_features)):
        fn = None
        if wanted and os.path.isfile(mod.weights_path()):
            fn = (lambda f: lambda x: f(x).cpu().numpy())(feats)
        elif wanted:
            print(missing.format(flag=flag, FLAG=flag.upper(),
                                 env=mod.WEIGHTS_ENV), flush=True)
        fns.append(fn)
    return tuple(fns)


def recon_samples(model, params, img, generator):
    """The model's reconstruction of `img` in [-1, 1], its shape: a
    diffusion model by DPM-Solver++ (`same_noise` as the config gives it,
    True by default) and the VQ decode; SLATE and STEVE by the AR
    decoder's greedy tokens; SA and SAVi by their broadcast decoder."""
    if params.model in DIFFUSION:
        return model.log_images(
            {"img": img}, generator, use_dpm=True,
            same_noise=getattr(params, "same_noise", True))["samples"]
    if params.model in TOKEN:
        return model.recon_img(model({"img": img}, testing=True)["slots"],
                               generator)
    return model({"img": img})["recon_img"]


def batch_results(x, y, fid_fn=None, fvd_fn=None, lpips_path=None):
    """One batch's results (the JAX script's keys, in its order) from its
    reconstruction `x` and truth `y` in [0, 1] ([B, H, W, 3], or clips [B,
    T, H, W, 3] whose frames are scored as images): mse, psnr, ssim, the
    LPIPS label when `lpips_path` (or the environment) names an `.npz`,
    then `_fid` / `_fvd`: (features of x, of y). Clips of fewer than 9
    frames take no FVD, which is said."""
    fvd_feats = None
    if fvd_fn is not None and x.dim() == 5:
        if x.shape[1] < fvd_ops.MIN_FRAMES:
            print(f"WARNING: T={x.shape[1]} < {fvd_ops.MIN_FRAMES}; I3D "
                  "needs >= 9, skipping FVD", flush=True)
        else:
            fvd_feats = (fvd_fn(x), fvd_fn(y))
    x = x.reshape(-1, *x.shape[-3:])
    y = y.reshape(-1, *y.shape[-3:])
    results = {"mse": M.mse_metric(x, y), "psnr": M.psnr_metric(x, y),
               "ssim": M.ssim_metric(x, y)}
    if lpips_ops.lpips_available(lpips_path):
        # the key carries the weights' provenance, never the bare name
        results[lpips_ops.weights_label("lpips", lpips_path)] = float(
            lpips_ops.lpips_distance(x * 2 - 1, y * 2 - 1,
                                     lpips_path).mean())
    if fid_fn is not None:
        results["_fid"] = (fid_fn(x), fid_fn(y))
    if fvd_feats is not None:
        results["_fvd"] = fvd_feats
    return results


def _dump(obj, path):
    """`dump_obj` through a temporary file and a rename: an interrupted
    write leaves the last whole cache."""
    tmp = f"{path}.tmp"
    dump_obj(obj, tmp)
    os.replace(tmp, path)


def frechet(cache, key):
    """The Frechet distance of the (generated, real) feature pairs under
    `key` in every cached batch, or None if none has them."""
    pairs = [r[key] for r in cache.values() if key in r]
    if not pairs:
        return None
    dim = pairs[0][0].shape[1]
    gen, real = fid_ops.FeatureStats(dim), fid_ops.FeatureStats(dim)
    for g, r in pairs:
        gen.update(g)
        real.update(r)
    return fid_ops.frechet_distance(*gen.finalize(), *real.finalize())


def recon_eval(model, params, batches, cache_path, device, fid_fn=None,
               fvd_fn=None, lpips_path=None, frames_dir="", total=None):
    """test_recon over `batches` (dicts with "img" [B, (T,) H, W, 3] in
    [-1, 1]), resuming from and rewriting the cache at `cache_path`;
    `frames_dir` set: each computed batch's reconstructed frames as PNGs
    `b{i:04d}_{j:03d}.png`. Prints a line a batch and the FINAL line.
    -> {metric: mean over the samples} with `fid` / `fvd` under their
    labels."""
    cache = load_obj(cache_path) if os.path.isfile(cache_path) else {}
    meters = {}
    for i, batch in enumerate(batches):
        if i in cache:
            results = cache[i]
        else:
            img = batch["img"].to(device)
            gen = torch.Generator(device=device).manual_seed(i)
            with torch.inference_mode():
                samples = recon_samples(model, params, img, gen)
            x = (samples.float() * 0.5 + 0.5).clamp(0, 1)
            y = (img.float() * 0.5 + 0.5).clamp(0, 1)
            results = batch_results(x, y, fid_fn, fvd_fn, lpips_path)
            if frames_dir:
                frames = x.reshape(-1, *x.shape[-3:]).cpu().numpy()
                for j, frame in enumerate(frames):
                    save_image(frame, os.path.join(
                        frames_dir, f"b{i:04d}_{j:03d}.png"))
            cache[i] = results
            _dump(cache, cache_path)
        n = batch["img"].shape[0]
        for k, v in results.items():
            if not k.startswith("_"):
                meters.setdefault(k, AverageMeter()).update(v, n)
        print(f"[{i}/{total if total is not None else '?'}] " + " ".join(
            f"{k}={m.avg:.4f}" for k, m in meters.items()), flush=True)
    final = {k: m.avg for k, m in meters.items()}
    for key, name, mod in (("_fid", "fid", fid_ops), ("_fvd", "fvd",
                                                      fvd_ops)):
        d = frechet(cache, key)
        if d is not None:
            final[mod.weights_label(name)] = d
    print("FINAL " + " ".join(f"{k}={v:.4f}" for k, v in final.items()),
          flush=True)
    return final


def comp_gen_eval(model, params, batches, out_dir, device, fid_fn=None,
                  fvd_fn=None, total=None):
    """Compositional generation over `batches`: each batch's slots
    shuffled across it and decoded; the composed frames in [0, 1] written
    to `out_dir` as `{count:06d}.png`, counted over the run; with
    `fid_fn` / `fvd_fn` their features against the real frames' (clips
    of fewer than 9 frames take no FVD). -> {"frames": count, and the
    FID / FVD under their labels}."""
    stats = {k: (fid_ops.FeatureStats(d), fid_ops.FeatureStats(d))
             for k, fn, d in (("fid", fid_fn, fid_ops.DIM),
                              ("fvd", fvd_fn, fvd_ops.DIM)) if fn}
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for i, batch in enumerate(batches):
        img = batch["img"].to(device)
        gen = torch.Generator(device=device).manual_seed(i)
        with torch.inference_mode():
            slots = shuffle_slots(encode_slots(model, params, img))
            samples = decode_slots(model, params, slots, gen)
        x = (samples.float() * 0.5 + 0.5).clamp(0, 1)
        real = (img.float() * 0.5 + 0.5).clamp(0, 1)
        if "fid" in stats:
            stats["fid"][0].update(fid_fn(x))
            stats["fid"][1].update(fid_fn(real.reshape(-1, *x.shape[1:])))
        if "fvd" in stats and real.dim() == 5:
            if real.shape[1] < fvd_ops.MIN_FRAMES:
                if i == 0:
                    print(f"WARNING: clips have T={real.shape[1]} < 9 "
                          "frames; I3D needs >= 9, skipping native FVD",
                          flush=True)
            else:  # the composed frames folded back into clips
                stats["fvd"][0].update(fvd_fn(x.reshape(real.shape)))
                stats["fvd"][1].update(fvd_fn(real))
        for frame in x.cpu().numpy():
            save_image(frame, os.path.join(out_dir, f"{count:06d}.png"))
            count += 1
        print(f"[{i}/{total if total is not None else '?'}] wrote {count} "
              "frames", flush=True)
    out = {"frames": count}
    for key, mod, unit in (("fid", fid_ops, "frames"),
                           ("fvd", fvd_ops, "clips")):
        if key in stats and stats[key][0].n:
            d = fid_ops.frechet_distance(*stats[key][0].finalize(),
                                         *stats[key][1].finalize())
            label = mod.weights_label(key.upper())
            out[label] = d
            print(f"native {label} (composed vs real, {stats[key][0].n} vs "
                  f"{stats[key][1].n} {unit}): {d:.3f}", flush=True)
    print(f"DONE: {count} composed frames in {out_dir}", flush=True)
    return out
