"""The WideResNet classifier (port of ust_run_tpu/models/wrn.py;
reference networks/wrn.py:8-119).

Pre-activation residual blocks with leaky ReLU, global average pool and a
linear head. Module names are upstream's (`conv1`,
`block{b}.layer.{i}.{bn1,conv1,bn2,conv2,convShortcut}`, `bn1`, `fc`),
which ust_run_tpu/utils/torch_import.py:202-227 reads. Forward: NHWC
float32 in, (B, num_classes) logits out (plus the pooled features with
`ood_test`). As in the JAX package, `drop_rate` is recorded but no dropout
is applied: its blocks are always called deterministic (wrn.py:40,86).
It is not on the train step's path.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ust_run_tpu_torch.models.layers import GroupedBatchNorm


def _conv(cin, cout, k, stride):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False)


class BasicBlock(nn.Module):
    def __init__(self, in_planes, out_planes, stride, bn_momentum=0.1,
                 leaky_slope=0.0):
        super().__init__()
        self.equal = in_planes == out_planes
        self.leaky_slope = leaky_slope
        self.bn1 = GroupedBatchNorm(in_planes, momentum=bn_momentum)
        self.conv1 = _conv(in_planes, out_planes, 3, stride)
        self.bn2 = GroupedBatchNorm(out_planes, momentum=bn_momentum)
        self.conv2 = _conv(out_planes, out_planes, 3, 1)
        if not self.equal:
            self.convShortcut = _conv(in_planes, out_planes, 1, stride)

    def forward(self, x):
        """wrn.py:40-62: both branches start from the pre-activation;
        the identity is the raw input when the widths agree."""
        pre = F.leaky_relu(self.bn1(x), self.leaky_slope)
        out = F.leaky_relu(self.bn2(self.conv1(pre)), self.leaky_slope)
        out = self.conv2(out)
        if self.equal:
            return x + out
        return self.convShortcut(pre) + out


class NetworkBlock(nn.Module):
    def __init__(self, n, in_planes, out_planes, stride, bn_momentum,
                 leaky_slope):
        super().__init__()
        self.layer = nn.Sequential(*[
            BasicBlock(in_planes if i == 0 else out_planes, out_planes,
                       stride if i == 0 else 1, bn_momentum, leaky_slope)
            for i in range(n)])

    def forward(self, x):
        return self.layer(x)


class WideResNet(nn.Module):
    def __init__(self, in_channel, depth, num_classes, widen_factor=1,
                 bn_momentum=0.1, leaky_slope=0.0, drop_rate=0.0):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"depth {depth} is not 6n + 4")
        n = (depth - 4) // 6
        widths = [16, 16 * widen_factor, 32 * widen_factor,
                  64 * widen_factor]
        self.leaky_slope = leaky_slope
        self.drop_rate = drop_rate
        self.conv1 = _conv(in_channel, widths[0], 3, 1)
        for b, stride in enumerate((1, 2, 2)):
            setattr(self, f"block{b + 1}",
                    NetworkBlock(n, widths[b], widths[b + 1], stride,
                                 bn_momentum, leaky_slope))
        self.bn1 = GroupedBatchNorm(widths[3], momentum=bn_momentum)
        self.fc = nn.Linear(widths[3], num_classes)

    def init_weights_(self, generator):
        """The JAX package's init: convolutions N(0, 2/(k*k*out))
        (wrn.py:17-22), the head lecun-normal (flax Dense: truncated at two
        standard deviations) with a zero bias."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Conv2d):
                    fan = mod.out_channels * mod.kernel_size[0] \
                        * mod.kernel_size[1]
                    mod.weight.normal_(0.0, math.sqrt(2.0 / fan),
                                       generator=generator)
            std = 1.0 / math.sqrt(self.fc.in_features) / .87962566103423978
            nn.init.trunc_normal_(self.fc.weight, 0.0, std, -2 * std,
                                  2 * std, generator=generator)
            self.fc.bias.zero_()
        return self

    def forward(self, x, ood_test=False):
        out = self.conv1(x.float().permute(0, 3, 1, 2))
        out = self.block3(self.block2(self.block1(out)))
        out = F.leaky_relu(self.bn1(out), self.leaky_slope)
        feat = out.mean(dim=(2, 3))
        logits = self.fc(feat)
        if ood_test:
            return logits, feat
        return logits


class build_WideResNet:
    """Builder matching wrn.py:107-119."""

    def __init__(self, depth=28, widen_factor=2, bn_momentum=0.01,
                 leaky_slope=0.0, dropRate=0.0):
        self.depth = depth
        self.widen_factor = widen_factor
        self.bn_momentum = bn_momentum
        self.leaky_slope = leaky_slope
        self.dropRate = dropRate

    def build(self, num_classes, in_channel):
        return WideResNet(in_channel=in_channel, depth=self.depth,
                          num_classes=num_classes,
                          widen_factor=self.widen_factor,
                          bn_momentum=self.bn_momentum,
                          leaky_slope=self.leaky_slope,
                          drop_rate=self.dropRate)
