"""The port's reference-layout converter (`convert.load_reference_state_dict`,
`export_reference_state_dict`, scripts/convert_checkpoint_torch.py)
against the JAX package's exporter and converter, on the repo's trained
checkpoints, one per family the JAX `_dispatch` maps.

For each, the checkpoint is restored once (raw parameters). Its JAX
`models/torch_export.py` output, wrapped as an original SlotDiffusion
file is (`{"state_dict": ...}`, `module.` prefixes, an LPIPS `loss.`
head), goes through the script and must equal
scripts/export_torch_checkpoint.py's port file bit for bit; the script's
`--to_torch` output of that port file, read by the JAX
`models/torch_convert.py`, must equal the checkpoint's flax parameters
bit for bit.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.utils import load_params
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import (export_reference_state_dict,
                                             load_reference_state_dict)
from slotdiffusion_tpu_torch.training.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXPORT = _script("export_torch_checkpoint")
CONVERT = _script("convert_checkpoint_torch")
JAX_CONVERT = _script("convert_checkpoint")
# export_torch_checkpoint.py's name of each family's trained checkpoint
FAMILIES = ("sa", "sa_ldm", "savi_ldm", "savi", "slate", "steve", "dvae",
            "vqvae", "slotformer", "ldmslotformer_long3", "readout")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("which", FAMILIES)
def test_reference_pth_round_trip_on_trained_checkpoint(which, tmp_path,
                                                        monkeypatch):
    import slotdiffusion_tpu.training.checkpoint as jax_ckpt
    params_path, weight, _ = EXPORT.DEFAULTS[which]
    params_path = os.path.join(REPO, params_path)
    weight = os.path.join(REPO, weight)
    jparams = load_params(params_path)
    variables = jax_ckpt.load_model_params(build_jax_model(jparams), weight,
                                           jparams, use_ema=False)
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    # export_torch_checkpoint.py's file, from this one restore
    monkeypatch.setattr(jax_ckpt, "load_model_params",
                        lambda *a, **k: variables)
    exported = str(tmp_path / "exported.pt")
    state = EXPORT.export(params_path, weight, exported, use_ema=False,
                          vqvae=which == "vqvae")
    name = state["config"]
    assert configs.get_config(name).model == jparams.model

    convert_fn, export_fn = JAX_CONVERT._dispatch(jparams)
    ref = {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
           for k, v in export_fn(tree).items()}
    ref["module.loss.perceptual_loss.lin0.model.1.weight"] = torch.ones(
        1, 64, 1, 1)
    torch.save({"state_dict": ref}, tmp_path / "reference.pth")
    out = str(tmp_path / "converted.pt")
    assert CONVERT.main(["--params", name, "--weight",
                         str(tmp_path / "reference.pth"), "--out", out]) == 0
    got = load_checkpoint(out)
    assert got["config"] == name and got["ema"] is False
    assert set(got["model"]) == set(state["model"])
    for k, v in state["model"].items():
        assert got["model"][k].dtype == v.dtype
        assert torch.equal(got["model"][k], v), k

    back = str(tmp_path / "back.pth")
    assert CONVERT.main(["--params", name, "--weight", exported, "--out",
                         back, "--to_torch"]) == 0
    sd = torch.load(back, map_location="cpu", weights_only=True)
    jtree = convert_fn({k: v.numpy() for k, v in sd["state_dict"].items()})
    want, mine = _leaves(tree), _leaves(jtree)
    assert mine and set(mine) <= set(want), set(mine) - set(want)
    for k, v in mine.items():
        assert v.shape == want[k].shape, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_to_torch_swaps_in_the_ema_shadow(tmp_path):
    """--use_ema writes the EMA shadow a trainer's file keeps in place of
    the raw tensors; without it the raw ones."""
    cfg = configs.get_config("ReadoutSynthetic")
    from slotdiffusion_tpu_torch.models import build_model
    sd = build_model(cfg, device="cpu").state_dict()
    shadow = {"linear2.weight": torch.full_like(sd["linear2.weight"], 7.0)}
    torch.save({"model": sd, "ema": {"shadow": shadow}, "step": 3},
               tmp_path / "ckpt_last.pt")
    for flag, want in ((["--use_ema"], shadow["linear2.weight"]),
                       ([], sd["linear2.weight"])):
        out = str(tmp_path / f"out{len(flag)}.pth")
        CONVERT.main(["--params", "ReadoutSynthetic", "--weight",
                      str(tmp_path / "ckpt_last.pt"), "--out", out,
                      "--to_torch", *flag])
        got = torch.load(out, weights_only=True)["state_dict"]
        assert torch.equal(got["linear2.weight"], want)
        assert torch.equal(got["linear1.weight"], sd["linear1.weight"])


def test_unexpected_missing_and_misshapen_tensors_raise_with_names():
    """A name the model lacks, a tensor the file lacks and a shape that
    differs each raise with the name; the frozen DINO ViT and a
    rollouter's learnable PEs, which a reference file never carries, keep
    the model's values; a family the JAX converter does not map raises."""
    cfg = configs.get_config("SAViLDMMoviFile64")
    from slotdiffusion_tpu_torch.models import build_model
    target = build_model(cfg, device="cpu").state_dict()
    ref = export_reference_state_dict(target, cfg)
    assert "dm_decoder.model.diffusion_model.out.2.weight" in ref
    assert "init_latents" in ref and "encoder.0.0.weight" in ref
    got = load_reference_state_dict(dict(ref), cfg, target)
    assert all(torch.equal(got[k], v) for k, v in target.items())
    with pytest.raises(KeyError, match="predictor.bogus.weight"):
        load_reference_state_dict(
            dict(ref, **{"predictor.bogus.weight": torch.zeros(1)}), cfg,
            target)
    gone = dict(ref)
    del gone["slot_attention.gru.bias_hh"]
    with pytest.raises(KeyError, match="savi.slot_attention.gru.bias_hh"):
        load_reference_state_dict(gone, cfg, target)
    bad = dict(ref, init_latents=torch.zeros(1, 2, 3))
    with pytest.raises(ValueError, match="savi.init_latents"):
        load_reference_state_dict(bad, cfg, target)

    # tensors a reference file does not carry keep the target's values
    extra = {"encoder.encoder.dino.cls_token": torch.ones(1, 1, 4),
             "rollouter.enc_t_pe": torch.ones(1, 3, 4)}
    for model in ("SADiffusion", "LDMSlotFormer"):
        tcfg = cfg.copy(model=model)
        kept = load_reference_state_dict({}, tcfg, {
            k: v for k, v in extra.items()
            if k.startswith("encoder") == (model == "SADiffusion")})
        assert all(torch.equal(v, extra[k]) for k, v in kept.items())
        assert not export_reference_state_dict(
            {"encoder.encoder.dino.cls_token": extra[
                "encoder.encoder.dino.cls_token"]}, tcfg)
    with pytest.raises(ValueError, match="DINOSAUR"):
        load_reference_state_dict({}, cfg.copy(model="DINOSAUR"), {})


def test_vqvae_3x3_shortcut_is_the_references_conv_shortcut():
    """A 3x3 shortcut of a VQ-VAE block is `conv_shortcut` in the
    reference (the JAX exporter names it by its kernel), `nin_shortcut`
    in the port, both ways."""
    cfg = configs.get_config("VQVAESynthetic64")
    w3 = torch.randn(8, 4, 3, 3)
    w1 = torch.randn(8, 4, 1, 1)
    port = {"encoder.down.0.block.0.nin_shortcut.weight": w3,
            "decoder.up.0.block.0.nin_shortcut.weight": w1}
    ref = export_reference_state_dict(port, cfg)
    assert set(ref) == {"encoder.down.0.block.0.conv_shortcut.weight",
                        "decoder.up.0.block.0.nin_shortcut.weight"}
    back = load_reference_state_dict(ref, cfg, port)
    assert all(torch.equal(back[k], v) for k, v in port.items())
