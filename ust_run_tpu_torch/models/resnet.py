"""The dilated ResNet backbone (port of ust_run_tpu/models/resnet.py;
reference networks/backbone/resnet.py).

ResNet-50/101 with the last two stages dilated instead of strided (output
stride 8), as the DeepLabV2 head uses it. Bottleneck blocks (expansion 4),
GroupedBatchNorm after every convolution, convolution weights drawn
kaiming-normal with fan_out, BatchNorm weight 1 and bias 0.

Module names are torchvision's (`conv1`, `bn1`, `layerS.i.convJ`,
`layerS.i.bnJ`, `layerS.i.downsample.0/1`, no `fc`), so an ImageNet
`.pth` loads into `state_dict()` directly and
ust_run_tpu/utils/torch_import.py:95-121 reads the port's state_dict.

Inside the models tensors are NCHW-shaped (channels_last in memory on the
card): `ResNet.forward` takes that layout and returns the four stage
outputs c1..c4 in it.

On a mesh with a space axis each rank runs a slab of whole rows of every
image (blocks of 16 at the input, so 8 at the stem's output and 2 at the
stride-8 stages): the stem, the max pool and every block's 3x3
convolution (strided or dilated) run through parallel/spatial.py with
halo rows as wide as their windows; the 1x1 convolutions, the strided
projection included, need none, since every slab starts on an even row.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ust_run_tpu_torch.models.layers import GroupedBatchNorm
from ust_run_tpu_torch.parallel import spatial


def kaiming_normal_out_(weight, generator):
    """N(0, 2 / fan_out), fan_out = out * kh * kw (torch's kaiming_normal_
    with mode='fan_out', the JAX package's variance_scaling(2, fan_out))."""
    fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                              generator=generator)


def _conv(cin, cout, k, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, k, stride=stride,
                     padding=dilation * (k // 2), dilation=dilation,
                     bias=False)


class Bottleneck(spatial.SlabAware):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 x4, each followed by BN, with
    a 1x1 strided projection on the identity when `downsample`
    (resnet.py:30-54). On a row slab the 3x3 takes its halo rows."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=False):
        super().__init__()
        width = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = GroupedBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = GroupedBatchNorm(planes)
        self.conv3 = _conv(planes, width, 1)
        self.bn3 = GroupedBatchNorm(width)
        self.downsample = nn.Sequential(_conv(inplanes, width, 1, stride),
                                        GroupedBatchNorm(width)) \
            if downsample else None

    def forward(self, x, **gkw):
        sizes = gkw.get("group_sizes")
        mesh = spatial.slab_mesh(self, sizes)
        out = F.relu(self.bn1(self.conv1(x), **gkw))
        out = spatial.conv(self.conv2, out, mesh, sizes)
        out = F.relu(self.bn2(out, **gkw))
        out = self.bn3(self.conv3(out), **gkw)
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](self.downsample[0](x), **gkw)
        return F.relu(out + identity)


class ResNet(spatial.SlabAware):
    """resnet.py:57-88: a 7x7 stride-2 stem, 3x3 stride-2 max pool, four
    stages of Bottlenecks (64/128/256/512 planes). Stages 3 and 4 trade
    their stride for dilation. The first block of every stage projects
    the identity, and its 3x3 conv runs at the PREVIOUS dilation
    (resnet.py:82)."""

    def __init__(self, layers, in_channels=3,
                 replace_stride_with_dilation=(False, True, True)):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = GroupedBatchNorm(64)
        inflate = [False] + list(replace_stride_with_dilation)
        inplanes, dilation = 64, 1
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                self.layers)):
            stride = 1 if stage == 0 else 2
            prev_dilation = dilation
            if inflate[stage]:
                dilation *= stride
                stride = 1
            blocks = [Bottleneck(inplanes, planes, stride, prev_dilation,
                                 downsample=True)]
            inplanes = planes * Bottleneck.expansion
            blocks += [Bottleneck(inplanes, planes, 1, dilation)
                       for _ in range(1, n)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def init_weights_(self, generator):
        """The JAX package's init: kaiming-normal fan_out convolutions
        (BatchNorm keeps weight 1, bias 0), drawn from `generator`."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                kaiming_normal_out_(mod.weight, generator)
        return self

    def forward(self, x, groups=1, group_sizes=None, group_valid=None):
        """x: NCHW -> [c1, c2, c3, c4] (resnet.py:173-183)."""
        gkw = dict(groups=groups, group_sizes=group_sizes,
                   group_valid=group_valid)
        mesh = spatial.slab_mesh(self, group_sizes)
        x = spatial.conv(self.conv1, x, mesh, group_sizes)
        x = F.relu(self.bn1(x, **gkw))
        x = spatial.max_pool2d(x, 3, 2, 1, mesh, group_sizes)
        feats = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, **gkw)
            feats.append(x)
        return feats


def resnet50(in_channels=3):
    return ResNet((3, 4, 6, 3), in_channels)


def resnet101(in_channels=3):
    return ResNet((3, 4, 23, 3), in_channels)
