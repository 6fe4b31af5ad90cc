"""The DeepLabV2 family: DeepLab v2 (arXiv:1606.00915) on torchvision's
ResNet with the last two stages dilated (output stride 8), from a
configuration's `model` block (`resnet_layers`, `aspp_dilations`), and
its weights' init rule.

State_dict keys as upstream's (`backbone.*` in torchvision's layout,
`classifier.{0..3}`). BatchNorm is torch.nn.BatchNorm2d, per group as the
step calls the model. The ASPP sum is resized with
F.interpolate(align_corners=True). Inputs and logits are NHWC.
"""

import math

import torch.nn.functional as F
from torch import nn

from benchmarks.reference.models import Conv2d


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=False):
        super().__init__()
        width = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, width, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, width, 1, stride=stride, bias=False),
            nn.BatchNorm2d(width)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Output stride 8: stages 3 and 4 dilate (2, 4) instead of striding;
    the first block of a stage runs its 3x3 at the previous dilation."""

    def __init__(self, layers, in_channels=3):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3,
                            bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes, dilation = 64, 1
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                layers)):
            stride = 1 if stage == 0 else 2
            prev = dilation
            if stage >= 2:
                dilation *= stride
                stride = 1
            blocks = [Bottleneck(inplanes, planes, stride, prev, True)]
            inplanes = planes * 4
            blocks += [Bottleneck(inplanes, planes, 1, dilation)
                       for _ in range(1, n)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class DeepLabV2(nn.Module):
    def __init__(self, layers, num_classes, in_channels=3,
                 dilations=(6, 12, 18, 24)):
        super().__init__()
        self.backbone = ResNet(layers, in_channels)
        self.classifier = nn.ModuleList(
            Conv2d(2048, num_classes, 3, padding=d, dilation=d, bias=True)
            for d in dilations)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).contiguous()
        h, w = x.shape[2:]
        c4 = self.backbone(x)
        out = sum(conv(c4) for conv in self.classifier)
        out = F.interpolate(out, size=(h, w), mode="bilinear",
                            align_corners=True)
        return out.permute(0, 2, 3, 1)


def build(config):
    m = config["model"]
    return DeepLabV2(tuple(m["resnet_layers"]), config["num_classes"],
                     config["channels"], tuple(m["aspp_dilations"]))


def init_rules(model):
    """Kaiming-normal fan-out convolutions in the backbone; N(0, 0.01)
    heads with zero biases."""
    rules = {}
    for prefix, m in model.named_modules():
        if not isinstance(m, Conv2d):
            continue
        w = m.weight
        if prefix.startswith("classifier."):
            rules[f"{prefix}.weight"] = ("normal", 0.01)
            rules[f"{prefix}.bias"] = ("const", 0.0)
        else:
            rules[f"{prefix}.weight"] = ("normal", math.sqrt(
                2.0 / (w.shape[0] * w[0, 0].numel())))
    return rules
