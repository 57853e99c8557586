"""Slot-attention image encoder (mirrors the GN-ResNet and plain-CNN
branches of the JAX package's models/sa.py:27-90): backbone ->
SoftPositionEmbed -> flatten -> LN -> Linear -> ReLU -> Linear. Parameter
names follow the upstream model: `encoder` (the ResNet, or one
`ConvNormAct` per layer, `encoder.{i}.0` its conv), `encoder_pos_embedding`,
`encoder_out_layer`. Everything computes in `compute_dtype`, as the JAX
encoder does in its `dtype`."""

import torch
from torch import nn

from .blocks import MLP, ConvNormAct, SoftPositionEmbed
from .resnet import STAGES, ResNet


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
        if enc_dict.get("resnet"):
            use_layer4 = enc_dict.get("use_layer4", False)
            self.encoder = ResNet(
                STAGES[enc_dict["resnet"]], small_inputs=True,
                use_layer4=use_layer4,
                replace_stride_with_dilation=tuple(enc_dict.get(
                    "replace_stride_with_dilation", (False, False, False))),
                **dt)
            ch = 512 if use_layer4 else 256
        elif enc_dict.get("dino"):
            raise ValueError("the DINO encoder is not ported: its weights "
                             "are not in the repo")
        else:
            self.encoder, ch = _plain_cnn(enc_dict, resolution,
                                          compute_dtype)
        self.encoder_pos_embedding = SoftPositionEmbed(ch, **dt)
        out = enc_dict["enc_out_channels"]
        self.encoder_out_layer = MLP(ch, [out], out, pre_norm=True, **dt)

    def forward(self, img):
        x = self.encoder(img.permute(0, 3, 1, 2).contiguous())  # NCHW
        x = self.encoder_pos_embedding(x.permute(0, 2, 3, 1))
        B, h, w, c = x.shape
        return self.encoder_out_layer(x.reshape(B, h * w, c)), (h, w)
