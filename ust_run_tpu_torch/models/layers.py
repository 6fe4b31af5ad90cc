"""GroupedBatchNorm and the torch-default initialisers (port of
ust_run_tpu/models/layers.py:33-180).

Tensors inside the model are NCHW-shaped (channels_last in memory on the
card). The reference runs 7-8 separate U-Net forwards per step, each with
train-mode BatchNorm over its own batch (train.py:643-702, 740). As in the
JAX package, several forwards share one batched call and BatchNorm
normalises each contiguous group of the batch on its own; running
statistics are folded group by group in call order.
"""

import functools
import math

import numpy as np
import torch
from torch import nn

from ust_run_tpu_torch.ops import grouped_bn


def torch_conv_init_(weight, generator):
    """Conv2d weight (out, in, kh, kw): U(-b, b), b = 1/sqrt(in*kh*kw)
    (torch's kaiming_uniform(a=sqrt(5)) default; layers.py:33-37)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    return _uniform_(weight, 1.0 / math.sqrt(fan_in), generator)


def torch_convT_init_(weight, generator):
    """ConvTranspose2d weight (in, out, kh, kw): torch computes fan_in on
    dim 1, the OUT channels (layers.py:40-45)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    return _uniform_(weight, 1.0 / math.sqrt(fan_in), generator)


def torch_bias_init_(bias, fan_in, generator):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (layers.py:48-54)."""
    return _uniform_(bias, 1.0 / math.sqrt(fan_in), generator)


def _uniform_(t, bound, generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


@functools.lru_cache(maxsize=None)
def _group_consts(group_sizes, total, hw, device):
    """Per-call constants, made once per shape, for a batch of the groups
    `group_sizes` cut from groups of `total` samples (the same sizes
    without a mesh): the groups' index (grouped_bn.Groups: each sample's
    group, each group's first sample), the (g, n) averaging matrix (row i
    holds 1/total_i at group i's samples, so that its product with the
    per-sample moments is the per-group mean, one product with no
    atomics), and the (g,) unbiased-variance factor cnt / max(cnt - 1, 1)
    with cnt = total * h * w."""
    seg = np.repeat(np.arange(len(group_sizes)), group_sizes)
    off = np.concatenate([[0], np.cumsum(group_sizes)])
    avg = np.zeros((len(group_sizes), len(seg)), np.float32)
    avg[seg, np.arange(len(seg))] = 1.0 / np.asarray(total, np.float32)[seg]
    cnt = np.asarray(total, np.float32) * np.float32(hw)
    corr = cnt / np.maximum(cnt - np.float32(1.0), np.float32(1.0))
    index = grouped_bn.Groups(
        torch.as_tensor(seg, dtype=torch.int32, device=device),
        torch.as_tensor(off, dtype=torch.int32, device=device))
    return (index, torch.as_tensor(avg, device=device),
            torch.as_tensor(corr, device=device))


def slab_hw(sizes, h, w):
    """The global H*W of a layer whose rank holds an (h, w) row slab of
    each image: the input's global height (sizes.height, a GroupSizes')
    scaled by the layer's width over the input's."""
    return sizes.height * w // sizes.width * w


class GroupedBatchNorm(nn.Module):
    """BatchNorm2d with per-group train-mode statistics.

    train(): normalise each of `groups` contiguous batch slices (or the
    unequal `group_sizes`) with its own biased statistics; fold the
    running statistics with momentum 0.1 and the unbiased variance,
    sequentially in group order. `group_valid` ((g,) bool tensor) leaves
    an invalid group out of the fold, as if its forward never happened.
    eval(): normalise with the running statistics.

    Statistics are float32 whatever the compute dtype: per-sample
    moments, then the group average, var = max(E[x^2] - E[x]^2, 0). The
    affine x*inv - shift (and the ReLU that follows, when the caller
    passes relu=True) is computed in float32 and rounded once to the
    compute dtype. The train-mode passes over the activation are
    ops/grouped_bn.py's (CUDA kernels on the card); the group arithmetic
    between them is `_coeffs`. Parameter and buffer names follow
    torch.nn.BatchNorm2d, so state_dicts keep upstream's layout.

    With `mesh` set (parallel.bind_mesh), the batch is this rank's
    slice of each group: `group_sizes` is the parallel.GroupSizes that
    mesh.shard returned (local sizes, possibly 0, and the global ones).
    Each rank averages its samples' moments over the global sizes and the
    averages are summed over the ranks, forward and backward
    (mesh.sum_sharded): the statistics, and so the running statistics
    every rank folds, are those of the global groups. On a space axis the
    rows are a slab of each image (GroupSizes.height set): the per-sample
    moments are the slab's sums over the image's global H*W
    (`slab_hw`), and so is the unbiased-variance count.
    """

    mesh = None

    def __init__(self, num_features, momentum=0.1, eps=1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x, groups=1, group_sizes=None, group_valid=None,
                relu=False):
        """`relu`: the ReLU that follows, fused into the normalisation."""
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x.float() - self.running_mean[:, None, None]) \
                * inv[:, None, None] + self.bias[:, None, None]
            y = y.to(x.dtype)
            return torch.relu(y) if relu else y

        n, c, h, w = x.shape
        if group_sizes is None:
            assert n % groups == 0, f"batch {n} not divisible by {groups}"
            group_sizes = (n // groups,) * groups
        total, hw = group_sizes, h * w
        if self.mesh is not None:
            assert hasattr(group_sizes, "total"), \
                "a synchronised GroupedBatchNorm takes mesh.shard's GroupSizes"
            total = group_sizes.total
            if group_sizes.height is not None:
                hw = slab_hw(group_sizes, h, w)
        group_sizes = tuple(group_sizes)
        assert sum(group_sizes) == n, (group_sizes, n)
        index, avg, corr = _group_consts(group_sizes, tuple(total), hw,
                                         x.device)
        with torch.autocast(device_type=x.device.type, enabled=False):
            y, mean, var = grouped_bn.grouped_bn(
                x, self.weight, self.bias,
                functools.partial(self._coeffs, avg, hw), index, relu)
        with torch.no_grad():
            self._fold_running(mean, var * corr[:, None], group_valid)
        return y

    def _coeffs(self, avg, hw, s1, s2, weight, bias):
        """The group arithmetic on the per-sample sums s1, s2 ((n, c)
        float32; on a row slab its sums, over the image's H*W `hw`):
        the groups' (inv, shift, mean, var), each (g, c) float32, with
        y = x * inv - shift."""
        mean, mean2 = avg @ (s1 / hw), avg @ (s2 / hw)               # (g, c)
        if self.mesh is not None:
            mean, mean2 = self.mesh.sum_sharded(
                torch.cat([mean, mean2], dim=1)).split(s1.shape[1], dim=1)
        var = torch.clamp(mean2 - torch.square(mean), min=0.0)
        inv = torch.rsqrt(var + self.eps) * weight
        return inv, mean * inv - bias, mean, var

    def _fold_running(self, mean, unbiased, group_valid):
        """Sequential EMA over groups in order (layers.py:163-179):
        r_G = (1-m)^#valid r_0 + m * sum_g (1-m)^(#valid after g) stat_g."""
        g = mean.shape[0]
        m = self.momentum
        if group_valid is None:
            after = torch.arange(g - 1, -1, -1, dtype=torch.float32,
                                 device=mean.device)
            wts = m * (1.0 - m) ** after
            decay = float(np.float32((1.0 - m) ** g))
            self.num_batches_tracked.add_(g)
        else:
            v = group_valid.to(torch.float32)
            after = torch.flip(torch.cumsum(torch.flip(v, [0]), 0), [0]) - v
            wts = m * (1.0 - m) ** after * v
            decay = (1.0 - m) ** torch.sum(v)
            self.num_batches_tracked.add_(group_valid.to(torch.long).sum())
        self.running_mean.copy_(decay * self.running_mean
                                + torch.sum(wts[:, None] * mean, dim=0))
        self.running_var.copy_(decay * self.running_var
                               + torch.sum(wts[:, None] * unbiased, dim=0))
