"""The U-Net family: the plain float32 U-Net of a configuration's `model`
block (`widths`), and its weights' init rule.

Written from the U-Net paper (arXiv:1505.04597) with upstream UST-RUN's
networks/unet_model.py layout and state_dict keys. BatchNorm is
torch.nn.BatchNorm2d: the step calls a model once per group, so each
group is normalised with its own statistics. Inputs and logits are NHWC.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmarks.reference.models import Conv2d, ConvTranspose2d


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


def build(config):
    return UNet(config["channels"], config["num_classes"],
                tuple(config["model"]["widths"]))


def init_rules(model):
    """torch's default convolution init: U(-b, b) with b = 1/sqrt(fan_in)
    for weights and biases."""
    rules = {}
    for prefix, m in model.named_modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            w = m.weight
            bound = 1.0 / math.sqrt(w.shape[1] * w[0, 0].numel())
            for k, _ in m.named_parameters(recurse=False):
                rules[f"{prefix}.{k}"] = ("uniform", bound)
    return rules
