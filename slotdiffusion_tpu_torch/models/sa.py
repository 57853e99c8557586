"""The Slot Attention image model (mirrors the JAX package's
models/sa.py:27-211): the slot-attention image encoder, the spatial
broadcast decoder and `SA`, the autoencoder of the two.

- `SAEncoder` (GN-ResNet, plain-CNN and frozen DINO ViT branches):
  backbone -> SoftPositionEmbed -> flatten -> LN -> Linear -> ReLU ->
  Linear. Parameter names follow the upstream model: `encoder` (the
  ResNet, one `ConvNormAct` per layer, `encoder.{i}.0` its conv, or
  `encoder.dino.` with the HF ViT's names), `encoder_pos_embedding`,
  `encoder_out_layer`. The DINO backbone is frozen: `SlotEncoding.
  frozen_encoder` names it for the trainer.
- `SpatialBroadcastDecoder`: each slot tiled over `dec_resolution`, a
  SoftPositionEmbed (`decoder_pos_embedding`), stride-2 `DeconvNormAct`s
  up to `resolution`, then stride 1, and a 1x1 conv to RGB + alpha
  (`decoder.{i}.0` the deconvs, `decoder.{n}` the 1x1 conv); a softmax of
  the alphas over the slots weights the slots' RGB into the image.
- `SlotEncoding`: the encode side every slot model shares (SA,
  SADiffusion, SAVi): `init_latents`, the `encoder` and `slot_attention`.
- `SA`: `init_latents` -> slot attention (no masks) -> the decoder, with
  the MSE `img_recon_loss`.

Everything computes in `compute_dtype`, as the JAX modules do in their
`dtype`; images are NHWC at the public functions."""

import torch
from torch import nn

from .blocks import MLP, Conv2d, ConvNormAct, DeconvNormAct, \
    SoftPositionEmbed
from .dino import DINOBackbone
from .resnet import STAGES, ResNet
from .slot_attention import SlotAttention


def _plain_cnn(enc_dict, resolution, compute_dtype):
    """The plain CNN of `enc_channels` (its first entry the input's
    channels), kernel `enc_ks`: stride 2 at the first layer only above 64
    pixels, a ReLU after every layer but the last."""
    channels = list(enc_dict["enc_channels"])
    n = len(channels) - 1
    return nn.Sequential(*[
        ConvNormAct(channels[i], channels[i + 1],
                    kernel_size=enc_dict.get("enc_ks", 5),
                    stride=2 if i == 0 and resolution[0] > 64 else 1,
                    norm=enc_dict.get("enc_norm", ""),
                    act="relu" if i != n - 1 else "",
                    compute_dtype=compute_dtype)
        for i in range(n)]), channels[-1]


class SAEncoder(nn.Module):
    """NHWC image [B, H, W, 3] -> (features [B, h*w, C_out], (h, w))."""

    def __init__(self, enc_dict, resolution, compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.dino = bool(enc_dict.get("dino"))
        if enc_dict.get("resnet"):
            use_layer4 = enc_dict.get("use_layer4", False)
            self.encoder = ResNet(
                STAGES[enc_dict["resnet"]], small_inputs=True,
                use_layer4=use_layer4,
                replace_stride_with_dilation=tuple(enc_dict.get(
                    "replace_stride_with_dilation", (False, False, False))),
                **dt)
            ch = 512 if use_layer4 else 256
        elif self.dino:
            self.encoder = DINOBackbone(enc_dict, resolution, compute_dtype)
            ch = self.encoder.out_channels
        else:
            self.encoder, ch = _plain_cnn(enc_dict, resolution,
                                          compute_dtype)
        self.encoder_pos_embedding = SoftPositionEmbed(ch, **dt)
        out = enc_dict["enc_out_channels"]
        self.encoder_out_layer = MLP(ch, [out], out, pre_norm=True, **dt)

    def forward(self, img):
        if self.dino:  # NHWC in and out
            x = self.encoder_pos_embedding(self.encoder(img))
        else:
            x = self.encoder(img.permute(0, 3, 1, 2).contiguous())  # NCHW
            x = self.encoder_pos_embedding(x.permute(0, 2, 3, 1))
        B, h, w, c = x.shape
        return self.encoder_out_layer(x.reshape(B, h * w, c)), (h, w)


class SpatialBroadcastDecoder(nn.Module):
    """slots [B, S, D] -> (image [B, H, W, 3], per-slot RGB [B, S, H, W,
    3], masks [B, S, H, W, 1] that sum to 1 over the slots)."""

    def __init__(self, resolution, dec_channels, dec_resolution, dec_ks=5,
                 dec_norm="", compute_dtype=torch.float32):
        super().__init__()
        self.resolution = tuple(resolution)
        self.dec_resolution = tuple(dec_resolution)
        dt = dict(compute_dtype=compute_dtype)
        self.decoder_pos_embedding = SoftPositionEmbed(dec_channels[0], **dt)
        layers, size = [], self.dec_resolution
        for cin, cout in zip(dec_channels[:-1], dec_channels[1:]):
            stride = 1 if size == self.resolution else 2
            layers.append(DeconvNormAct(cin, cout, dec_ks, stride, dec_norm,
                                        "relu", **dt))
            size = (size[0] * stride, size[1] * stride)
        if size != self.resolution:
            raise ValueError(f"decoder output {size} != resolution "
                             f"{self.resolution}; adjust dec_resolution/"
                             "dec_channels")
        layers.append(Conv2d(dec_channels[-1], 4, 1, **dt))
        self.decoder = nn.Sequential(*layers)

    def forward(self, slots):
        B, S, D = slots.shape
        x = slots.reshape(B * S, 1, 1, D).expand(B * S, *self.dec_resolution,
                                                 D)
        x = self.decoder_pos_embedding(x).permute(0, 3, 1, 2)
        x = self.decoder(x.contiguous()).permute(0, 2, 3, 1)
        x = x.reshape(B, S, *self.resolution, 4)
        recons, masks = x[..., :3], torch.softmax(x[..., 3:], dim=1)
        return (recons * masks).sum(1), recons, masks


class SlotEncoding(nn.Module):
    """The encode side of a slot model: `init_latents` [1, S, D] (the
    learned initial slots, drawn from N(0, 1) by `init_reference_`), the
    `SAEncoder` `encoder` and `slot_attention` (its kernel as
    `slot_dict["use_pallas"]` asks, "auto" the f32 formula; the masks of
    the last iteration with `return_last_attn`)."""

    def __init__(self, resolution, slot_dict, enc_dict, eps=1e-6,
                 return_last_attn=False, compute_dtype=torch.float32):
        super().__init__()
        self.resolution = tuple(resolution)
        self.num_slots = slot_dict["num_slots"]
        self.slot_size = slot_dict["slot_size"]
        self.compute_dtype = compute_dtype
        self.init_latents = nn.Parameter(
            torch.zeros(1, self.num_slots, self.slot_size))
        self.encoder = SAEncoder(enc_dict, self.resolution, compute_dtype)
        self.slot_attention = SlotAttention(
            in_features=enc_dict["enc_out_channels"],
            num_iterations=slot_dict["num_iterations"],
            slot_size=self.slot_size,
            mlp_hidden_size=slot_dict["slot_mlp_size"], eps=eps,
            return_last_attn=return_last_attn,
            use_pallas=slot_dict.get("use_pallas", "auto"),
            compute_dtype=compute_dtype)

    def init_slots(self, batch):
        """`init_latents` over a batch, in the compute dtype."""
        return self.init_latents.to(self.compute_dtype).expand(batch, -1, -1)

    @property
    def frozen_encoder(self):
        """The frozen DINO ViT, when the encoder is one: () otherwise."""
        return (self.encoder.encoder.dino,) if self.encoder.dino else ()


class SA(SlotEncoding):
    """The Slot Attention autoencoder on NHWC images [B, H, W, 3]."""

    # the trainer's EMA, when a config asks for one, covers every parameter
    ema_prefix = ""
    use_ema = False

    @property
    def frozen_modules(self):
        """What the trainer freezes: a DINO encoder."""
        return self.frozen_encoder

    def __init__(self, resolution, slot_dict, enc_dict, dec_dict, eps=1e-6,
                 compute_dtype=torch.float32):
        super().__init__(resolution, slot_dict, enc_dict, eps,
                         return_last_attn=False, compute_dtype=compute_dtype)
        self.decoder = SpatialBroadcastDecoder(
            self.resolution, tuple(dec_dict["dec_channels"]),
            tuple(dec_dict["dec_resolution"]), dec_dict.get("dec_ks", 5),
            dec_dict.get("dec_norm", ""), compute_dtype)

    def encode(self, img, init_slots=None):
        """img [B, H, W, 3] -> slots [B, S, D]."""
        feats, _ = self.encoder(img)
        if init_slots is None:
            init_slots = self.init_slots(img.shape[0])
        return self.slot_attention(feats, init_slots)

    def forward(self, data_dict, train=True, testing=False):
        """-> {"slots"} with `testing`, else also "recon_img", "recons"
        and "masks" (the decoder's)."""
        slots = self.encode(data_dict["img"])
        if testing:
            return {"slots": slots}
        recon_img, recons, masks = self.decoder(slots)
        return {"recon_img": recon_img, "recons": recons, "masks": masks,
                "slots": slots}

    def compute_losses(self, data_dict, generator=None, train=True):
        """-> (outputs, {"img_recon_loss": the f32 MSE of the
        reconstruction}). SA draws nothing: `generator` is the trainer's
        protocol."""
        out = self(data_dict, train=train)
        loss = ((out["recon_img"].float() - data_dict["img"].float()) ** 2
                ).mean()
        return out, {"img_recon_loss": loss}
