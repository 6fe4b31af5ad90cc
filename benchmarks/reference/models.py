"""Plain float32 models: the U-Net and DeepLabV2 on the dilated ResNet.

Written from the published descriptions (U-Net, arXiv:1505.04597, with
upstream UST-RUN's networks/unet_model.py layout; DeepLab v2,
arXiv:1606.00915, on torchvision's ResNet with the last two stages
dilated) with upstream's state_dict keys, so the benchmark loads one set
of weights into these and into the program's models. BatchNorm is
torch.nn.BatchNorm2d: the step calls a model once per group, so each
group is normalised with its own statistics and the running statistics
fold group by group, as in upstream's separate forwards. The ASPP sum is
resized with F.interpolate(align_corners=True).

Inputs and logits are NHWC float32. `precision` selects how the
convolutions round their operands, for the control that decides
`correct`: "fp32" (TF32 is switched by the caller), or "fp8": input,
weight and output quantised to float8 e4m3 with one scale per tensor,
and the output's gradient to e5m2, as fp8 training does.
"""

import torch
import torch.nn.functional as F
from torch import nn


def _quantise(x, dtype, fmax):
    scale = fmax / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _quantise(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _quantise(grad, torch.float8_e5m2, 57344.0)


class Conv2d(nn.Conv2d):
    precision = "fp32"

    def forward(self, x):
        if self.precision != "fp8":
            return super().forward(x)
        y = self._conv_forward(_Fp8.apply(x), _Fp8.apply(self.weight),
                               self.bias)
        return _Fp8.apply(y)


class ConvTranspose2d(nn.ConvTranspose2d):
    precision = "fp32"

    def forward(self, x):
        if self.precision != "fp8":
            return super().forward(x)
        y = F.conv_transpose2d(_Fp8.apply(x), _Fp8.apply(self.weight),
                               self.bias, self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return _Fp8.apply(y)


def set_precision(model, precision):
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.precision = precision
    return model


# ------------------------------------------------------------------ U-Net
class DoubleConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.double_conv = nn.Sequential(
            Conv2d(cin, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout),
            nn.ReLU(), Conv2d(cout, cout, 3, padding=1, bias=False),
            nn.BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.up = ConvTranspose2d(cin, cin // 2, 2, stride=2)
        self.conv = DoubleConv(cin, cout)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    def __init__(self, in_channels, num_classes, widths=(64, 128, 256, 512,
                                                         1024)):
        super().__init__()
        w = widths
        self.inc = DoubleConv(in_channels, w[0])
        self.down1 = Down(w[0], w[1])
        self.down2 = Down(w[1], w[2])
        self.down3 = Down(w[2], w[3])
        self.down4 = Down(w[3], w[4])
        self.up1 = Up(w[4], w[3])
        self.up2 = Up(w[3], w[2])
        self.up3 = Up(w[2], w[1])
        self.up4 = Up(w[1], w[0])
        self.outc = OutConv(w[0], num_classes)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).contiguous()
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.outc(y).permute(0, 2, 3, 1)


# ------------------------------------------------------- DeepLabV2 / ResNet
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
    """The plain model of a configuration file's `model` block."""
    m = config["model"]
    if m["family"] == "unet":
        return UNet(config["channels"], config["num_classes"],
                    tuple(m["widths"]))
    if m["family"] == "deeplabv2":
        return DeepLabV2(tuple(m["resnet_layers"]), config["num_classes"],
                         config["channels"], tuple(m["aspp_dilations"]))
    raise ValueError(f"unknown model family {m['family']!r}")
