"""Slot-attention image encoder (mirrors the GN-ResNet branch of
the JAX package's models/sa.py:27-90): backbone -> SoftPositionEmbed ->
flatten -> LN -> Linear -> ReLU -> Linear. Parameter names follow the
upstream model: `encoder`, `encoder_pos_embedding`, `encoder_out_layer`."""

from torch import nn

from .blocks import MLP, SoftPositionEmbed
from .resnet import STAGES, ResNet


class SAEncoder(nn.Module):
    """NHWC image [B, H, W, 3] -> (features [B, h*w, C_out], (h, w))."""

    def __init__(self, enc_dict):
        super().__init__()
        if not enc_dict.get("resnet"):
            raise ValueError("only the GN-ResNet encoder is ported")
        use_layer4 = enc_dict.get("use_layer4", False)
        self.encoder = ResNet(
            STAGES[enc_dict["resnet"]], small_inputs=True,
            use_layer4=use_layer4,
            replace_stride_with_dilation=tuple(enc_dict.get(
                "replace_stride_with_dilation", (False, False, False))))
        ch = 512 if use_layer4 else 256
        self.encoder_pos_embedding = SoftPositionEmbed(ch)
        out = enc_dict["enc_out_channels"]
        self.encoder_out_layer = MLP(ch, [out], out, pre_norm=True)

    def forward(self, img):
        x = self.encoder(img.permute(0, 3, 1, 2).contiguous())  # NCHW
        x = self.encoder_pos_embedding(x.permute(0, 2, 3, 1))
        B, h, w, c = x.shape
        return self.encoder_out_layer(x.reshape(B, h * w, c)), (h, w)
