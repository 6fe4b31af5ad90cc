"""The plain U-Net (port of ust_run_tpu/models/unet.py:37-199 with
bilinear=False; reference networks/unet_model.py + unet_parts.py).

Five levels, widths 64->1024, DoubleConv = (3x3 conv no-bias -> BN ->
ReLU) x2, Down = 2x2 maxpool + DoubleConv, Up = 2x2 stride-2 transpose
conv + pad-to-match + concat [skip, upsampled] + DoubleConv, 1x1 out conv.

On a mesh with a space axis each rank runs a slab of whole rows of every
image (blocks of 16, the total downsampling): the 3x3 convolutions take
halo rows from their neighbours, and the pools, transpose convolutions,
concatenations and the 1x1 out conv need nothing.

Module names follow upstream's torch keys (`inc.double_conv.N`,
`downN.maxpool_conv.1.double_conv.N`, `upN.up`, `upN.conv.double_conv.N`,
`outc.conv`), so `state_dict()` has upstream's layout.

The public forward takes and returns NHWC, like the JAX package; inside,
tensors are NCHW-shaped and channels_last in memory. `amp` runs the
model under bf16 autocast (f32 parameters, f32 BN statistics, f32
logits out).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ust_run_tpu_torch.models.layers import (GroupedBatchNorm,
                                             torch_bias_init_,
                                             torch_conv_init_,
                                             torch_convT_init_)
from ust_run_tpu_torch.parallel import spatial


class DoubleConv(spatial.SlabAware):
    """(conv3x3 -> BN -> ReLU) x2 (reference unet_parts.py:8-25), each
    ReLU fused into its GroupedBatchNorm.

    With `mesh` bound (parallel.bind_mesh) and a call on a row slab (its
    GroupSizes carry the image's height), each 3x3 convolution takes its
    halo rows from the neighbouring slabs (parallel/spatial.py) with the
    module's own weight."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            GroupedBatchNorm(out_ch),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
            GroupedBatchNorm(out_ch),
            nn.ReLU(inplace=True),
        )

    def forward(self, x, **gkw):
        mesh = spatial.slab_mesh(self, gkw.get("group_sizes"))
        # each ReLU runs inside the BatchNorm before it (relu=True); the
        # nn.ReLU modules stay in the Sequential for its module names
        conv1, bn1, _, conv2, bn2, _ = self.double_conv
        for conv, bn in ((conv1, bn1), (conv2, bn2)):
            x = conv(x) if mesh is None \
                else spatial.conv3x3(x, conv.weight, mesh)
            x = bn(x, relu=True, **gkw)
        return x


class Down(nn.Module):
    """maxpool 2x2 + DoubleConv (reference unet_parts.py:28-39)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(in_ch, out_ch))

    def forward(self, x, **gkw):
        return self.maxpool_conv[1](self.maxpool_conv[0](x), **gkw)


class Up(nn.Module):
    """2x2 stride-2 transpose conv, pad-to-match, concat [skip, upsampled]
    (torch.cat([x2, x1], dim=1)), DoubleConv (unet_parts.py:42-68)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_ch, in_ch // 2, 2, stride=2)
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x1, x2, **gkw):
        x1 = self.up(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        return self.conv(torch.cat([x2, x1], dim=1), **gkw)


class OutConv(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """Reference networks/unet_model.py:6-38 with bilinear=False."""

    def __init__(self, n_channels, n_classes, amp=False):
        super().__init__()
        self.n_channels = n_channels
        self.n_classes = n_classes
        self.amp = amp
        self.inc = DoubleConv(n_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 1024)
        self.up1 = Up(1024, 512)
        self.up2 = Up(512, 256)
        self.up3 = Up(256, 128)
        self.up4 = Up(128, 64)
        self.outc = OutConv(64, n_classes)

    def init_weights_(self, generator):
        """The JAX package's torch-default init (layers.py:33-54), drawn
        from `generator`."""
        for mod in self.modules():
            if isinstance(mod, nn.ConvTranspose2d):
                torch_convT_init_(mod.weight, generator)
                torch_bias_init_(mod.bias, mod.in_channels, generator)
            elif isinstance(mod, nn.Conv2d):
                torch_conv_init_(mod.weight, generator)
                if mod.bias is not None:
                    torch_bias_init_(mod.bias, mod.in_channels, generator)
        return self

    def forward(self, x, groups=1, group_sizes=None, group_valid=None):
        """x: (B, H, W, C) NHWC -> f32 logits (B, H, W, n_classes)."""
        gkw = dict(groups=groups, group_sizes=group_sizes,
                   group_valid=group_valid)
        x = x.permute(0, 3, 1, 2)          # NCHW view, channels_last memory
        # no cast cache: each weight is cast once per call anyway, and a
        # cache would hold tensors across a CUDA graph capture's boundary
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=self.amp, cache_enabled=False):
            x1 = self.inc(x, **gkw)
            x2 = self.down1(x1, **gkw)
            x3 = self.down2(x2, **gkw)
            x4 = self.down3(x3, **gkw)
            x5 = self.down4(x4, **gkw)
            y = self.up1(x5, x4, **gkw)
            y = self.up2(y, x3, **gkw)
            y = self.up3(y, x2, **gkw)
            y = self.up4(y, x1, **gkw)
            logits = self.outc(y)
        return logits.float().permute(0, 2, 3, 1)
