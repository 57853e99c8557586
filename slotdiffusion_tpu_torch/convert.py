"""JAX-package parameters -> the port's `state_dict`; and the original
SlotDiffusion's torch layout <-> the port's (`load_reference_state_dict`,
`export_reference_state_dict`, at the end).

Takes the flax param tree of a JAX-package model as nested dicts
of numpy arrays (e.g. `jax.tree_util.tree_map(np.asarray, params)`) and
returns `{name: torch.Tensor}` for `load_state_dict`. The walks are copies
of the ones the JAX package's `models/torch_export.py` uses for
`export_torch_sa` (:225), `export_torch_sa_diffusion` (:260),
`export_torch_savi_diffusion` (:287-318), `export_torch_slate` and
`export_torch_steve` (:320-352), `export_torch_ldm_slotformer`
(:375-396), `export_torch_savi` (:398-411), the MLP and LSTM predictors
(:442-479), `export_torch_dvae` (:510-531), `export_torch_slot_rollouter`
(:533-549), `export_torch_physion_readout` (:552-559) and
`export_torch_steve_transformer` (:562-587); the port's modules carry
the upstream names those walks emit, so only the prefixes differ.

Layout rules: conv [kh, kw, C, F] -> [F, C, kh, kw]; transposed conv
[kh, kw, C, F] -> [C, F, kh, kw] flipped in both spatial axes (flax's
ConvTranspose convolves the dilated input with the kernel as it is,
torch's with the kernel flipped: `_inv_deconv`, torch_export.py:189);
dense [in, out] -> [out, in]; norm scale/bias -> weight/bias.
"""

from typing import Dict, Sequence

import numpy as np
import torch


def _np(x):
    return np.asarray(x)


def _conv(out, prefix, sub, bias=True):
    out[f"{prefix}.weight"] = np.transpose(_np(sub["kernel"]), (3, 2, 0, 1))
    if bias:
        out[f"{prefix}.bias"] = _np(sub["bias"])


def _deconv(out, prefix, sub):
    k = np.transpose(_np(sub["kernel"]), (2, 3, 0, 1))
    out[f"{prefix}.weight"] = k[:, :, ::-1, ::-1]
    out[f"{prefix}.bias"] = _np(sub["bias"])


def _linear(out, prefix, sub):
    out[f"{prefix}.weight"] = np.transpose(_np(sub["kernel"]))
    if "bias" in sub:
        out[f"{prefix}.bias"] = _np(sub["bias"])


def _norm(out, prefix, sub):
    g = sub["GroupNorm_0"]
    out[f"{prefix}.weight"] = _np(g["scale"])
    out[f"{prefix}.bias"] = _np(g["bias"])


def _layernorm(out, prefix, sub):
    out[f"{prefix}.weight"] = _np(sub["scale"])
    out[f"{prefix}.bias"] = _np(sub["bias"])


def _resblock(out, p, sub):
    _norm(out, f"{p}.in_layers.0", sub["GroupNorm32_0"])
    _conv(out, f"{p}.in_layers.2", sub["Conv_0"])
    _linear(out, f"{p}.emb_layers.1", sub["Dense_0"])
    _norm(out, f"{p}.out_layers.0", sub["GroupNorm32_1"])
    _conv(out, f"{p}.out_layers.3", sub["Conv_1"])
    if "Conv_2" in sub:
        _conv(out, f"{p}.skip_connection", sub["Conv_2"])


def _spatial_transformer(out, p, sub, depth):
    _norm(out, f"{p}.norm", sub["GroupNorm32_0"])
    _conv(out, f"{p}.proj_in", sub["Conv_0"])
    _conv(out, f"{p}.proj_out", sub["Conv_1"])
    for d in range(depth):
        bp, blk = f"{p}.transformer_blocks.{d}", sub[f"block{d}"]
        for i in range(3):
            _layernorm(out, f"{bp}.norm{i + 1}", blk[f"LayerNorm_{i}"])
        for a in ("attn1", "attn2"):
            for name in ("to_q", "to_k", "to_v"):
                _linear(out, f"{bp}.{a}.{name}", blk[a][name])
            _linear(out, f"{bp}.{a}.to_out.0", blk[a]["to_out"])
        _linear(out, f"{bp}.ff.net.0.proj", blk["GEGLU_0"]["Dense_0"])
        _linear(out, f"{bp}.ff.net.2", blk["Dense_0"])


def convert_unet(params, num_res_blocks: int, channel_mult: Sequence[int],
                 attention_resolutions: Sequence[int],
                 transformer_depth: int = 1, resblock_updown: bool = False,
                 conv_resample: bool = True) -> Dict[str, np.ndarray]:
    """flax UNetModel params -> port UNetModel names (block indices
    replayed as the UNet builds them). The resamplers between levels are
    ResBlocks under `resblock_updown` (the JAX exporter's
    models/torch_export.py:129, 154), convs under `conv_resample`, else
    parameter-free (pooling, nearest x2)."""
    out: Dict[str, np.ndarray] = {}
    _linear(out, "time_embed.0", params["Dense_0"])
    _linear(out, "time_embed.2", params["Dense_1"])
    _conv(out, "input_blocks.0.0", params["conv_in"])
    _norm(out, "out.0", params["GroupNorm32_0"])
    _conv(out, "out.2", params["conv_out"])
    idx, ds = 1, 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            _resblock(out, f"input_blocks.{idx}.0",
                      params[f"down{level}_res{i}"])
            if ds in attention_resolutions:
                _spatial_transformer(out, f"input_blocks.{idx}.1",
                                     params[f"down{level}_attn{i}"],
                                     transformer_depth)
            idx += 1
        if level != len(channel_mult) - 1:
            if resblock_updown:
                _resblock(out, f"input_blocks.{idx}.0",
                          params[f"down{level}_ds"])
            elif conv_resample:
                _conv(out, f"input_blocks.{idx}.0.op",
                      params[f"down{level}_ds"]["Conv_0"])
            idx += 1
            ds *= 2
    _resblock(out, "middle_block.0", params["mid_res1"])
    _spatial_transformer(out, "middle_block.1", params["mid_attn"],
                         transformer_depth)
    _resblock(out, "middle_block.2", params["mid_res2"])
    j = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            _resblock(out, f"output_blocks.{j}.0",
                      params[f"up{level}_res{i}"])
            pos = 1
            if ds in attention_resolutions:
                _spatial_transformer(out, f"output_blocks.{j}.{pos}",
                                     params[f"up{level}_attn{i}"],
                                     transformer_depth)
                pos += 1
            if level > 0 and i == num_res_blocks:
                if resblock_updown:
                    _resblock(out, f"output_blocks.{j}.{pos}",
                              params[f"up{level}_us"])
                elif conv_resample:
                    _conv(out, f"output_blocks.{j}.{pos}.conv",
                          params[f"up{level}_us"]["Conv_0"])
                ds //= 2
            j += 1
    return out


def convert_slot_attention(params) -> Dict[str, np.ndarray]:
    t = np.transpose
    return {
        "norm_inputs.weight": _np(params["ln_in_scale"]),
        "norm_inputs.bias": _np(params["ln_in_bias"]),
        "project_k.weight": t(_np(params["wk"])),
        "project_v.weight": t(_np(params["wv"])),
        "project_q.0.weight": _np(params["ln_q_scale"]),
        "project_q.0.bias": _np(params["ln_q_bias"]),
        "project_q.1.weight": t(_np(params["wq"])),
        "gru.weight_ih": t(_np(params["gru_wi"])),
        "gru.bias_ih": _np(params["gru_bi"]),
        "gru.weight_hh": t(_np(params["gru_wh"])),
        "gru.bias_hh": _np(params["gru_bh"]),
        "mlp.0.weight": _np(params["ln_mlp_scale"]),
        "mlp.0.bias": _np(params["ln_mlp_bias"]),
        "mlp.1.weight": t(_np(params["w1"])),
        "mlp.1.bias": _np(params["b1"]),
        "mlp.3.weight": t(_np(params["w2"])),
        "mlp.3.bias": _np(params["b2"]),
    }


def convert_resnet(params, stage_sizes, use_layer4=False):
    """flax GN-ResNet params -> torchvision names."""
    out: Dict[str, np.ndarray] = {}
    _conv(out, "conv1", params["Conv_0"], bias=False)
    _norm(out, "bn1", params["_GN_0"])
    bidx = 0
    for stage in range(4 if use_layer4 else 3):
        for i in range(stage_sizes[stage]):
            p, blk = f"layer{stage + 1}.{i}", params[f"BasicBlock_{bidx}"]
            _conv(out, f"{p}.conv1", blk["Conv_0"], bias=False)
            _norm(out, f"{p}.bn1", blk["_GN_0"])
            _conv(out, f"{p}.conv2", blk["Conv_1"], bias=False)
            _norm(out, f"{p}.bn2", blk["_GN_1"])
            if "Conv_2" in blk:
                _conv(out, f"{p}.downsample.0", blk["Conv_2"], bias=False)
                _norm(out, f"{p}.downsample.1", blk["_GN_2"])
            bidx += 1
    return out


def _conv_norm(out, prefix, sub, norm):
    """The norm of a ConvNormAct / DeconvNormAct: GroupNorm32_0 or
    LayerNorm_0, or none."""
    if norm in ("gn", "group_norm", "groupnorm"):
        _norm(out, prefix, sub["GroupNorm32_0"])
    elif norm:
        _layernorm(out, prefix, sub["LayerNorm_0"])


def convert_plain_cnn(params, num_layers, norm=""):
    """flax SAEncoder plain-CNN layers -> port `encoder.{i}` names (the
    JAX package's torch_export.py:_inv_sa_encoder_side walk): each
    ConvNormAct_{i} holds Conv_0 and, with a norm, GroupNorm32_0 or
    LayerNorm_0."""
    out: Dict[str, np.ndarray] = {}
    for i in range(num_layers):
        sub = params[f"ConvNormAct_{i}"]
        _conv(out, f"{i}.0", sub["Conv_0"])
        _conv_norm(out, f"{i}.1", sub, norm)
    return out


def _flatten(tree, prefix=""):
    """Nested dicts -> {"a/b/c": leaf}, flax's flattened paths."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def convert_dino(params):
    """flax DINOEncoder params -> the port's DINOEncoder names (the HF
    ViTModel's): the inverse of the JAX package's `convert_hf_dino_flat`
    (models/dino.py:116-163): q/k/v [in, heads, hd] -> [out, in], the
    output [heads, hd, out] -> [out, in], the patch conv [kh, kw, C, F]
    -> [F, C, kh, kw], dense [in, out] -> [out, in]."""
    from .models import dino
    depth = sum(1 for k in params if k.startswith("block"))
    return dino.convert_flat(_flatten(params), depth)


def convert_sa_encoder(params, enc_dict):
    """flax SAEncoder -> port SAEncoder names: the GN-ResNet, plain-CNN or
    DINO walk, as `enc_dict` picks the encoder."""
    from .models.resnet import STAGES
    if enc_dict.get("dino"):
        backbone = {f"dino.{k}": v for k, v in
                    convert_dino(params["DINOEncoder_0"]).items()}
    elif enc_dict.get("resnet"):
        backbone = convert_resnet(params["ResNet_0"],
                                  STAGES[enc_dict["resnet"]],
                                  enc_dict.get("use_layer4", False))
    else:
        backbone = convert_plain_cnn(params,
                                     len(enc_dict["enc_channels"]) - 1,
                                     enc_dict.get("enc_norm", ""))
    out = {f"encoder.{k}": v for k, v in backbone.items()}
    _linear(out, "encoder_pos_embedding.dense",
            params["SoftPositionEmbed_0"]["Dense_0"])
    _layernorm(out, "encoder_out_layer.0", params["LayerNorm_0"])
    _linear(out, "encoder_out_layer.1", params["Dense_0"])
    _linear(out, "encoder_out_layer.3", params["Dense_1"])
    return out


def convert_spatial_broadcast_decoder(params, dec_dict):
    """flax SpatialBroadcastDecoder -> port names (the JAX package's
    torch_export.py:export_torch_sa decoder walk): the position
    embedding, one DeconvNormAct a layer, the 1x1 conv."""
    n = len(dec_dict["dec_channels"]) - 1
    out: Dict[str, np.ndarray] = {}
    _linear(out, "decoder_pos_embedding.dense",
            params["SoftPositionEmbed_0"]["Dense_0"])
    for i in range(n):
        sub = params[f"DeconvNormAct_{i}"]
        _deconv(out, f"decoder.{i}.0", sub["ConvTranspose_0"])
        _conv_norm(out, f"decoder.{i}.1", sub, dec_dict.get("dec_norm", ""))
    _conv(out, f"decoder.{n}", params["Conv_0"])
    return out


def _slot_encoder(out, params, enc_dict):
    """The encode side an image model shares: `init_latents`, the
    SAEncoder and slot attention."""
    out["init_latents"] = _np(params["init_latents"])
    out.update({f"encoder.{k}": v for k, v in convert_sa_encoder(
        params["encoder"], enc_dict).items()})
    out.update({f"slot_attention.{k}": v for k, v in convert_slot_attention(
        params["slot_attention"]).items()})


def convert_sa(params, cfg) -> Dict[str, torch.Tensor]:
    """flax SA params -> port SA state_dict, for the config `cfg`."""
    out: Dict[str, np.ndarray] = {}
    _slot_encoder(out, params, cfg.enc_dict)
    out.update({f"decoder.{k}": v for k, v in
                convert_spatial_broadcast_decoder(
                    params["decoder"], cfg.dec_dict).items()})
    return _tensors(out)


def convert_sa_diffusion(params, cfg) -> Dict[str, torch.Tensor]:
    """flax SADiffusion params -> port SADiffusion state_dict, for the
    config `cfg`."""
    out: Dict[str, np.ndarray] = {}
    _slot_encoder(out, params, cfg.enc_dict)
    out.update({f"dm_decoder.{k}": v for k, v in convert_diffusion(
        params["dm_decoder"], cfg.dec_dict).items()})
    return _tensors(out)


def convert_model(params, cfg) -> Dict[str, torch.Tensor]:
    """flax params of the model `cfg.model` names -> the port's
    state_dict."""
    fn = {"SA": convert_sa, "SADiffusion": convert_sa_diffusion,
          "SAViDiffusion": convert_savi_diffusion, "SAVi": convert_savi,
          "SLATE": convert_slate, "STEVE": convert_steve,
          "dVAE": convert_dvae_state_dict,
          "DVAE": convert_dvae_state_dict,
          "SlotFormer": convert_slotformer,
          "LDMSlotFormer": convert_ldm_slotformer,
          "PhysionReadout": convert_physion_readout}.get(cfg.model)
    if fn is None:
        if cfg.model == "VQVAE":
            return convert_vqvae_state_dict(params, cfg.enc_dec_dict)
        raise ValueError(f"model {cfg.model!r} is not ported yet")
    return fn(params, cfg)


def convert_mlp_predictor(params):
    """flax ResidualMLPPredictor -> `ln`, `mlp.{2i}` (the JAX package's
    torch_export.py:export_torch_mlp_predictor)."""
    out: Dict[str, np.ndarray] = {}
    _layernorm(out, "ln", params["LayerNorm_0"])
    i = 0
    while f"Dense_{i}" in params:
        _linear(out, f"mlp.{2 * i}", params[f"Dense_{i}"])
        i += 1
    return out


def convert_rnn_predictor(params, base_fn):
    """flax RNNPredictorWrapper -> `base_predictor.*`, `out_projector`
    and the torch LSTM layout `rnn.{weight,bias}_{ih,hh}_l{i}` (gates i,
    f, g, o; the JAX package's torch_export.py:export_torch_rnn_predictor):
    flax's cell keeps one bias, on the recurrent side, which goes into
    `bias_ih` with zeros in `bias_hh` (the cell adds both)."""
    out = {f"base_predictor.{k}": v for k, v in base_fn(
        params["base"]).items()}
    _linear(out, "out_projector", params["out_proj"])
    layer = 0
    while f"lstm{layer}" in params:
        cell = params[f"lstm{layer}"]
        gates = ("i", "f", "g", "o")
        out[f"rnn.weight_ih_l{layer}"] = np.concatenate(
            [np.transpose(_np(cell[f"i{g}"]["kernel"])) for g in gates])
        out[f"rnn.weight_hh_l{layer}"] = np.concatenate(
            [np.transpose(_np(cell[f"h{g}"]["kernel"])) for g in gates])
        b = np.concatenate([_np(cell[f"h{g}"]["bias"]) for g in gates])
        out[f"rnn.bias_ih_l{layer}"] = b
        out[f"rnn.bias_hh_l{layer}"] = np.zeros_like(b)
        layer += 1
    return out


def convert_predictor(params, pred_dict):
    """The predictor a config's `pred_dict` builds (the JAX
    `build_predictor`): the transformer or the MLP, in the LSTM wrapper
    with `pred_rnn`."""
    if pred_dict.get("pred_type", "transformer") == "mlp":
        base_fn = convert_mlp_predictor
    else:
        layers = pred_dict.get("pred_num_layers", 2)
        base_fn = lambda p: convert_transformer_predictor(p, layers)
    if pred_dict.get("pred_rnn", False):
        return convert_rnn_predictor(params, base_fn)
    return base_fn(params)


def _savi_encoder(out, prefix, savi, cfg):
    """A SAVi's encode side under `prefix`: `init_latents`, the
    SAEncoder, slot attention and the predictor (if the config has one)."""
    sub = {}
    _slot_encoder(sub, savi, cfg.enc_dict)
    if "predictor" in savi:
        sub.update({f"predictor.{k}": v for k, v in convert_predictor(
            savi["predictor"], cfg.pred_dict).items()})
    out.update({f"{prefix}{k}": v for k, v in sub.items()})


def convert_savi(params, cfg) -> Dict[str, torch.Tensor]:
    """flax SAVi params (the baseline) -> port SAVi state_dict (the JAX
    package's torch_export.py:export_torch_savi walk, the decoder under
    `decoder.` as the port's SA keeps it)."""
    out: Dict[str, np.ndarray] = {}
    _savi_encoder(out, "", params, cfg)
    out.update({f"decoder.{k}": v for k, v in
                convert_spatial_broadcast_decoder(
                    params["decoder"], cfg.dec_dict).items()})
    return _tensors(out)


def convert_dvae(params) -> Dict[str, np.ndarray]:
    """flax DVAE params -> upstream dVAE names (the JAX package's
    torch_export.py:export_torch_dvae): Conv2dBlock `{i}.m` (the conv)
    and `{i}.weight`/`{i}.bias` (its GroupNorm); the pixel shuffles at
    decoder.5 and decoder.10 hold nothing."""
    out: Dict[str, np.ndarray] = {}

    def block(prefix, sub):
        _conv(out, f"{prefix}.m", sub["Conv_0"], bias=False)
        out[f"{prefix}.weight"] = _np(sub["GroupNorm_0"]["scale"])
        out[f"{prefix}.bias"] = _np(sub["GroupNorm_0"]["bias"])

    for i in range(7):
        block(f"encoder.{i}", params[f"enc_blocks_{i}"])
    _conv(out, "encoder.7", params["enc_out"])
    for i in range(5):
        block(f"decoder.{i}", params[f"dec_blocks1_{i}"])
    for i in range(4):
        block(f"decoder.{i + 6}", params[f"dec_blocks2_{i}"])
    _conv(out, "decoder.11", params["dec_out"])
    return out


def convert_dvae_state_dict(params, cfg=None) -> Dict[str, torch.Tensor]:
    """A bare JAX DVAE's params -> the port DVAE's state_dict, which
    `build_model` of a "dVAE" config loads strictly and
    `graft_pretrained` takes as it is."""
    return _tensors(convert_dvae(params))


def convert_ar_decoder(params) -> Dict[str, np.ndarray]:
    """flax STEVETransformerDecoder -> upstream names (the JAX package's
    torch_export.py:export_torch_steve_transformer)."""
    out: Dict[str, np.ndarray] = {}
    _linear(out, "in_proj", params["in_proj"])
    out["tok_emb.weight"] = _np(params["tok_emb"]["embedding"])
    out["pos_emb.pe"] = _np(params["pos_emb"])
    _layernorm(out, "tf_dec.layer_norm", params["final_ln"])
    _linear(out, "head", params["head"])
    i = 0
    while f"block{i}" in params:
        p, blk = f"tf_dec.blocks.{i}", params[f"block{i}"]
        _layernorm(out, f"{p}.self_attn_layer_norm", blk["self_attn_ln"])
        _layernorm(out, f"{p}.encoder_decoder_attn_layer_norm",
                   blk["cross_ln"])
        _layernorm(out, f"{p}.ffn_layer_norm", blk["ffn_ln"])
        for name, sub in (("self_attn", blk["self_attn"]),
                          ("encoder_decoder_attn", blk["cross_attn"])):
            for k in ("proj_q", "proj_k", "proj_v", "proj_o"):
                _linear(out, f"{p}.{name}.{k}", sub[k])
        _linear(out, f"{p}.ffn.0", blk["ffn_fc1"])
        _linear(out, f"{p}.ffn.2", blk["ffn_fc2"])
        i += 1
    return out


def _token_parts(out, params):
    out.update({f"dvae.{k}": v for k, v in convert_dvae(
        params["dvae"]).items()})
    out.update({f"trans_decoder.{k}": v for k, v in convert_ar_decoder(
        params["trans_decoder"]).items()})


def convert_slate(params, cfg) -> Dict[str, torch.Tensor]:
    """flax SLATE params -> port SLATE state_dict (the JAX package's
    torch_export.py:export_torch_slate)."""
    out: Dict[str, np.ndarray] = {}
    _slot_encoder(out, params, cfg.enc_dict)
    _token_parts(out, params)
    return _tensors(out)


def convert_steve(params, cfg) -> Dict[str, torch.Tensor]:
    """flax STEVE params -> port STEVE state_dict (the JAX package's
    torch_export.py:export_torch_steve, the encode side under `savi.`)."""
    out: Dict[str, np.ndarray] = {}
    _savi_encoder(out, "savi.", params["savi"], cfg)
    _token_parts(out, params)
    return _tensors(out)


def _mha(out, prefix, sub):
    """flax MultiHeadDotProductAttention -> nn.MultiheadAttention's packed
    `in_proj` and `out_proj` (the JAX exporter's `_inv_mha`,
    torch_export.py:413)."""
    D = _np(sub["out"]["bias"]).shape[0]
    out[f"{prefix}.in_proj_weight"] = np.concatenate(
        [np.transpose(_np(sub[n]["kernel"]).reshape(D, D))
         for n in ("query", "key", "value")], axis=0)
    out[f"{prefix}.in_proj_bias"] = np.concatenate(
        [_np(sub[n]["bias"]).reshape(D) for n in ("query", "key", "value")],
        axis=0)
    out[f"{prefix}.out_proj.weight"] = np.transpose(
        _np(sub["out"]["kernel"]).reshape(D, D))
    out[f"{prefix}.out_proj.bias"] = _np(sub["out"]["bias"])


def convert_transformer_predictor(params, num_layers):
    """flax TransformerPredictor -> torch TransformerEncoderLayer names
    (packed in_proj)."""
    out: Dict[str, np.ndarray] = {}
    for i in range(num_layers):
        p = f"transformer_encoder.layers.{i}"
        _mha(out, f"{p}.self_attn", params[f"attn{i}"])
        _layernorm(out, f"{p}.norm1", params[f"LayerNorm_{2 * i}"])
        _layernorm(out, f"{p}.norm2", params[f"LayerNorm_{2 * i + 1}"])
        _linear(out, f"{p}.linear1", params[f"Dense_{2 * i}"])
        _linear(out, f"{p}.linear2", params[f"Dense_{2 * i + 1}"])
    return out


def _vq_resblock(out, p, sub):
    _norm(out, f"{p}.norm1", sub["GroupNorm32_0"])
    _conv(out, f"{p}.conv1", sub["Conv_0"])
    _norm(out, f"{p}.norm2", sub["GroupNorm32_1"])
    _conv(out, f"{p}.conv2", sub["Conv_1"])
    if "Conv_2" in sub:
        _conv(out, f"{p}.nin_shortcut", sub["Conv_2"])


def _vq_attnblock(out, p, sub):
    _norm(out, f"{p}.norm", sub["GroupNorm32_0"])
    for i, name in enumerate(("q", "k", "v", "proj_out")):
        _conv(out, f"{p}.{name}", sub[f"Conv_{i}"])


def convert_vqvae(params, enc_dec_dict):
    """flax VQVAE params -> port VQVAE names (upstream layout). `params`
    is the tree of a bare VQVAE (a stage-1 run's `params`) or the
    `dm_decoder/vae/vqvae` subtree of an LDM; the mid attention exists
    unless `attn_type` is "none", a level's attention where its
    resolution is in `attn_resolutions`."""
    ch_mult = list(enc_dec_dict["ch_mult"])
    nrb = enc_dec_dict["num_res_blocks"]
    attn = enc_dec_dict.get("attn_type", "vanilla") == "vanilla"
    attn_res = tuple(enc_dec_dict.get("attn_resolutions", ()))
    out: Dict[str, np.ndarray] = {}
    for side, enc in (("encoder", params["encoder"]),
                      ("decoder", params["decoder"])):
        _conv(out, f"{side}.conv_in", enc["conv_in"])
        _vq_resblock(out, f"{side}.mid.block_1", enc["mid_res1"])
        if attn:
            _vq_attnblock(out, f"{side}.mid.attn_1", enc["mid_attn"])
        _vq_resblock(out, f"{side}.mid.block_2", enc["mid_res2"])
        _norm(out, f"{side}.norm_out", enc["norm_out"])
        _conv(out, f"{side}.conv_out", enc["conv_out"])
    enc, dec = params["encoder"], params["decoder"]
    res = enc_dec_dict.get("resolution", 128)
    for level in range(len(ch_mult)):
        # the encoder's resolution at this level is the decoder's too
        level_attn = attn and res // 2 ** level in attn_res
        for i in range(nrb):
            _vq_resblock(out, f"encoder.down.{level}.block.{i}",
                         enc[f"down{level}_res{i}"])
            if level_attn:
                _vq_attnblock(out, f"encoder.down.{level}.attn.{i}",
                              enc[f"down{level}_attn{i}"])
        if level != len(ch_mult) - 1:
            _conv(out, f"encoder.down.{level}.downsample.conv",
                  enc[f"down{level}_ds"])
        for i in range(nrb + 1):
            _vq_resblock(out, f"decoder.up.{level}.block.{i}",
                         dec[f"up{level}_res{i}"])
            if level_attn:
                _vq_attnblock(out, f"decoder.up.{level}.attn.{i}",
                              dec[f"up{level}_attn{i}"])
        if level != 0:
            _conv(out, f"decoder.up.{level}.upsample.conv",
                  dec[f"up{level}_us"])
    out["quantize.embedding.weight"] = _np(params["quantize"]["embedding"])
    _conv(out, "quant_conv", params["quant_conv"])
    _conv(out, "post_quant_conv", params["post_quant_conv"])
    return out


def _tensors(out) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def convert_vqvae_state_dict(params, enc_dec_dict) -> Dict[str,
                                                           torch.Tensor]:
    """A bare JAX VQVAE's params -> the port VQVAE's state_dict (f32
    tensors), which `build_model` of a "VQVAE" config loads strictly and
    `graft_pretrained` takes as it is."""
    return _tensors(convert_vqvae(params, enc_dec_dict))


def convert_savi_diffusion(params, cfg) -> Dict[str, torch.Tensor]:
    """flax SAViDiffusion params -> port SAViDiffusion state_dict, for the
    config `cfg` (the same nested dicts both packages read)."""
    out: Dict[str, np.ndarray] = {}

    def put(prefix, d):
        out.update({f"{prefix}.{k}": v for k, v in d.items()})

    savi = params["savi"]
    out["savi.init_latents"] = _np(savi["init_latents"])
    put("savi.encoder", convert_sa_encoder(savi["encoder"], cfg.enc_dict))
    put("savi.slot_attention", convert_slot_attention(
        savi["slot_attention"]))
    put("savi.predictor", convert_predictor(savi["predictor"],
                                            cfg.pred_dict))
    put("dm_decoder", convert_diffusion(params["dm_decoder"], cfg.dec_dict))
    return _tensors(out)


def convert_diffusion(params, dec_dict) -> Dict[str, np.ndarray]:
    """flax CondDDPM / DDPM / LDM params -> the port decoder's names: the
    UNet (under "concat" its conv_in already takes the context's
    channels), and the VQ-VAE when `dec_dict` has a `vae_dict` (a
    pixel-space decoder has none)."""
    ud = dec_dict["unet_dict"]
    out = {f"unet.{k}": v for k, v in convert_unet(
        params["unet"], ud["num_res_blocks"], ud["channel_mult"],
        ud["attention_resolutions"], ud.get("transformer_depth", 1),
        ud.get("resblock_updown", False),
        ud.get("conv_resample", True)).items()}
    if dec_dict.get("vae_dict"):
        out.update({f"vae.vqvae.{k}": v for k, v in convert_vqvae(
            params["vae"]["vqvae"],
            dec_dict["vae_dict"]["enc_dec_dict"]).items()})
    return out


def convert_diffusion_state_dict(params, dec_dict) -> Dict[str,
                                                           torch.Tensor]:
    """A bare JAX diffusion decoder's params -> the port decoder's
    state_dict (f32 tensors), for a strict `load_state_dict`."""
    return _tensors(convert_diffusion(params, dec_dict))


def convert_slot_rollouter(params) -> Dict[str, np.ndarray]:
    """flax SlotRollouter -> port names (the JAX exporter's
    `export_torch_slot_rollouter` walk, torch_export.py:533-549): in_proj,
    out_proj, and per layer `transformer_encoder.layers.i.{self_attn,
    norm1, norm2, linear1, linear2}`. Unlike that walk, a learnable
    `enc_t_pe` / `enc_slots_pe` is carried (a sine PE is no parameter on
    either side), so a learnable-PE model loads strictly."""
    out: Dict[str, np.ndarray] = {}
    step = params["step"]
    _linear(out, "in_proj", step["in_proj"])
    _linear(out, "out_proj", step["out_proj"])
    n = sum(1 for k in step if k.startswith("layer"))
    for i in range(n):
        p, layer = f"transformer_encoder.layers.{i}", step[f"layer{i}"]
        _mha(out, f"{p}.self_attn", layer["attn"])
        _layernorm(out, f"{p}.norm1", layer["LayerNorm_0"])
        _layernorm(out, f"{p}.norm2", layer["LayerNorm_1"])
        _linear(out, f"{p}.linear1", layer["Dense_0"])
        _linear(out, f"{p}.linear2", layer["Dense_1"])
    for pe in ("enc_t_pe", "enc_slots_pe"):
        if pe in params:
            out[pe] = _np(params[pe])
    return out


def convert_slotformer(params, cfg) -> Dict[str, torch.Tensor]:
    """flax SlotFormer params -> port SlotFormer state_dict: the
    rollouter, and the spatial broadcast decoder where the config has
    one."""
    out = {f"rollouter.{k}": v for k, v in
           convert_slot_rollouter(params["rollouter"]).items()}
    if "decoder" in params:
        out.update({f"decoder.{k}": v for k, v in
                    convert_spatial_broadcast_decoder(
                        params["decoder"], cfg.dec_dict).items()})
    return _tensors(out)


def convert_ldm_slotformer(params, cfg) -> Dict[str, torch.Tensor]:
    """flax LDMSlotFormer params -> port LDMSlotFormer state_dict: the
    rollouter and the frozen LDM (the walks of the JAX exporter's
    `export_torch_ldm_slotformer`, torch_export.py:375-396)."""
    out = {f"rollouter.{k}": v for k, v in
           convert_slot_rollouter(params["rollouter"]).items()}
    out.update({f"dm_decoder.{k}": v for k, v in convert_diffusion(
        params["dm_decoder"], cfg.dec_dict).items()})
    return _tensors(out)


def convert_physion_readout(params, cfg=None) -> Dict[str, torch.Tensor]:
    """flax PhysionReadout params -> port names (`linear1`, `linear2`;
    the JAX exporter's torch_export.py:552-559; the pair indices are a
    buffer outside the state_dict)."""
    out: Dict[str, np.ndarray] = {}
    _linear(out, "linear1", params["linear1"])
    _linear(out, "linear2", params["linear2"])
    return _tensors(out)


# ---- the reference's torch layout (original SlotDiffusion checkpoints) ----
#
# The port's modules carry the reference's names; only the prefixes of
# the wrapping modules differ. Each family's rules are (port prefix,
# reference prefix) pairs, the first that matches wins; a name no rule
# matches is the same on both sides. The families are the JAX package's
# `scripts/convert_checkpoint.py:_dispatch` ones (:81-168).

_ENCODE = (("encoder.encoder.", "encoder."),
           ("encoder.encoder_pos_embedding.", "encoder_pos_embedding."),
           ("encoder.encoder_out_layer.", "encoder_out_layer."))
_SAVI_ENCODE = tuple((f"savi.{p}", r) for p, r in _ENCODE) + (
    ("savi.init_latents", "init_latents"),
    ("savi.slot_attention.", "slot_attention."),
    ("savi.predictor.", "predictor."))
_BROADCAST = (("decoder.decoder_pos_embedding.", "decoder_pos_embedding."),
              ("decoder.decoder.", "decoder."))
_UNET = (("dm_decoder.unet.", "dm_decoder.model.diffusion_model."),)
REFERENCE_RULES = {
    "SA": _ENCODE + _BROADCAST, "SAVi": _ENCODE + _BROADCAST,
    "SADiffusion": _ENCODE + _UNET, "SAViDiffusion": _SAVI_ENCODE + _UNET,
    "SLATE": _ENCODE, "STEVE": _SAVI_ENCODE, "VQVAE": (), "dVAE": (),
    "DVAE": (), "SlotFormer": _BROADCAST, "LDMSlotFormer": _UNET,
    "PhysionReadout": ()}
# port tensors a reference file does not carry, each with the reason; the
# port's state_dict holds no buffer (the tables the reference keeps as
# buffers, the schedules, causal masks and pair indices, the port
# recomputes outside it), so none is named for that
NOT_IN_REFERENCE = (
    (".dino.", "the frozen DINO ViT: the public pretrained weights, which "
     "the reference reloads and its checkpoints do not carry (the JAX "
     "exporter's _strip_dino)"),
    ("rollouter.enc_t_pe", "a learnable PE of the rollouter, which the "
     "JAX exporter drops"),
    ("rollouter.enc_slots_pe", "a learnable PE of the rollouter, which "
     "the JAX exporter drops"))


def _reference_rules(cfg):
    if cfg.model not in REFERENCE_RULES:
        raise ValueError(f"no converter dispatch for model {cfg.model!r}")
    return REFERENCE_RULES[cfg.model]


def clean_reference_state_dict(sd):
    """The JAX converter's `_clean_torch_sd` rules (scripts/
    convert_checkpoint.py:32-42): unwrap `{"state_dict": ...}`, strip
    `module.` (DDP) and drop the `loss.` LPIPS/VGG heads."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("loss."):
            continue
        out[k] = v
    return out


def _not_in_reference(name):
    return next((why for pat, why in NOT_IN_REFERENCE if pat in name), None)


def load_reference_state_dict(sd, cfg, target):
    """A reference-layout state dict (an original SlotDiffusion `.pth`,
    or what `export_reference_state_dict` or the JAX package's
    `models/torch_export.py` writes) -> the port's state_dict for a
    strict `load_state_dict` of the model `cfg` builds, whose own
    state_dict is `target`. The tensors the reference does not carry
    (`NOT_IN_REFERENCE`) keep `target`'s values; a VQ-VAE 3x3 shortcut
    (`conv_shortcut`) is the port's `nin_shortcut`. Any other name the
    model has and the file lacks, any the file has and the model lacks,
    and any shape that differs raises with the names."""
    rules = _reference_rules(cfg)
    got = {}
    for k, v in clean_reference_state_dict(sd).items():
        name = next((p + k[len(r):] for p, r in rules if k.startswith(r)),
                    k).replace(".conv_shortcut.", ".nin_shortcut.")
        got[name] = torch.as_tensor(v)
    unexpected = sorted(set(got) - set(target))
    if unexpected:
        raise KeyError(f"{len(unexpected)} names the {cfg.model} model "
                       f"does not have: {unexpected[:8]}")
    out = {}
    missing = []
    for k, t in target.items():
        if k in got:
            if got[k].shape != t.shape:
                raise ValueError(f"{k}: the file's {tuple(got[k].shape)}, "
                                 f"the model's {tuple(t.shape)}")
            out[k] = got[k].to(t.dtype)
        elif _not_in_reference(k):
            out[k] = t
        else:
            missing.append(k)
    if missing:
        raise KeyError(f"the file lacks {len(missing)} tensors of the "
                       f"{cfg.model} model: {missing[:8]}")
    return out


def export_reference_state_dict(port_sd, cfg):
    """The port's state_dict -> the reference's names (the inverse of
    `load_reference_state_dict`), what the JAX package's
    `models/torch_convert.py` reads: the frozen DINO ViT is left out (the
    reference reloads the public weights); a VQ-VAE 3x3 shortcut is named
    `conv_shortcut`, as the reference (and the JAX exporter) names it."""
    rules = _reference_rules(cfg)
    out = {}
    for k, v in port_sd.items():
        if ".dino." in k:
            continue
        name = next((r + k[len(p):] for p, r in rules if k.startswith(p)),
                    k)
        if ".nin_shortcut." in name and v.dim() == 4 and v.shape[-1] == 3:
            name = name.replace(".nin_shortcut.", ".conv_shortcut.")
        out[name] = v
    return out
