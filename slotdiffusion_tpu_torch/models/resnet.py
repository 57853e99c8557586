"""GroupNorm ResNet18/34 feature extractor, small-input stem
(mirrors the JAX package's models/resnet.py:25-140). Parameter names are
torchvision's (conv1, bn1, layerK.i.conv1, ...)."""

from torch import nn


def _gn(ch):
    return nn.GroupNorm(min(32, ch), ch, eps=1e-5)


class BasicBlock(nn.Module):
    def __init__(self, in_ch, planes, stride=1, dilation=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn1 = _gn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = _gn(planes)
        self.relu = nn.ReLU()
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, planes, 1, stride, bias=False), _gn(planes))

    def forward(self, x):
        h = self.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(h + identity)


class ResNet(nn.Module):
    """NCHW feature map, no pooling head. `small_inputs`: 3x3 stride-1 stem
    without max-pool; `use_layer4=False` stops at 256 channels, stride 4."""

    def __init__(self, stage_sizes, small_inputs=True, use_layer4=True,
                 replace_stride_with_dilation=(False, False, False)):
        super().__init__()
        if small_inputs:
            self.conv1 = nn.Conv2d(3, 64, 3, 1, padding=1, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = _gn(64)
        self.relu = nn.ReLU()
        self.maxpool = None if small_inputs else nn.MaxPool2d(3, 2, 1)
        planes = (64, 128, 256, 512)
        in_ch, dilation = 64, 1
        self.num_stages = 4 if use_layer4 else 3
        for stage in range(self.num_stages):
            stride = 1 if stage == 0 else 2
            prev_dilation = dilation
            if stage > 0 and replace_stride_with_dilation[stage - 1]:
                dilation *= stride
                stride = 1
            blocks = []
            for i in range(stage_sizes[stage]):
                blocks.append(BasicBlock(
                    in_ch, planes[stage], stride if i == 0 else 1,
                    prev_dilation if i == 0 else dilation))
                in_ch = planes[stage]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        if self.maxpool is not None:
            x = self.maxpool(x)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x


STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
