"""The Unet2D family (port of ust_run_tpu/models/unet2d.py; reference
networks/unet.py).

ConvD/ConvU blocks with a pluggable normalisation (bn: GroupedBatchNorm;
gn: GroupNorm(1, C), eps 1e-5; in: InstanceNorm without affine or running
statistics; dsbn: DomainSpecificBatchNorm2d), `Unet2D`, `Unet2D_MT`
(segmentation and reconstruction heads), `Encoder`/`Decoder`,
`RecDecoder` (DSBN-conditionable), `Unet2D_DS` (deep supervision),
`Unet2D_MS` (multi-scale heads) and the PatchGAN-style `Discriminator`.
Convolutions have biases; weights are drawn kaiming-normal with fan_out
and biases U(-b, b), b = 1/sqrt(out * k * k), as in the JAX package.
Bilinear upsampling is align_corners=False (nn.Upsample, unet.py:85),
computed as two interpolation-matrix products (spatial.resize_bilinear:
no atomics in its backward, so the step is run-to-run deterministic).

Module names are upstream's flat torch layout (`convd{1..5}.{conv,bn}J`,
`convu{4..1}.{conv,bn}J`, `seg1`, `rec1`, `out1`), which
ust_run_tpu/utils/torch_import.py:172-199 reads for norm='bn'; a DSBN
layer holds `bns.{d}.*`. The Discriminator's convolutions are `c0`..`c4`,
the JAX package's names. Public forwards take and return NHWC float32;
inside, tensors are NCHW-shaped. `Unet2D` keeps the UNet's call contract
(`groups`, `group_sizes`, `group_valid` reach every GroupedBatchNorm).

`Unet2D` with norm='bn' runs on a mesh with a space axis: each rank holds
a slab of whole rows of every image (blocks of 16, the total
downsampling, so one row a block at the bottom level); ConvD's and ConvU's
3x3 convolutions, ConvU's bilinear upsampling and `seg1` run through
parallel/spatial.py with halo rows, the 2x2 pools and 1x1 convolutions
need none.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ust_run_tpu_torch.models.dsbn import DomainSpecificBatchNorm2d
from ust_run_tpu_torch.models.layers import GroupedBatchNorm, torch_bias_init_
from ust_run_tpu_torch.models.resnet import kaiming_normal_out_
from ust_run_tpu_torch.parallel import spatial


def _conv(cin, cout, k, stride=1, padding=None):
    return nn.Conv2d(cin, cout, k, stride=stride,
                     padding=k // 2 if padding is None else padding)


def normalization(planes, norm="bn", num_domains=None):
    """The normalization() factory (unet.py:17-28)."""
    if norm == "bn":
        return GroupedBatchNorm(planes)
    if norm == "gn":
        return nn.GroupNorm(1, planes, eps=1e-5)
    if norm == "in":
        return nn.InstanceNorm2d(planes, eps=1e-5)
    if norm == "dsbn":
        return DomainSpecificBatchNorm2d(planes, num_domains)
    raise ValueError(norm)


def _norm(mod, x, domain_label, gkw):
    if isinstance(mod, GroupedBatchNorm):
        return mod(x, **gkw)
    if isinstance(mod, DomainSpecificBatchNorm2d):
        if domain_label is None:
            raise ValueError("norm='dsbn' needs a domain_label")
        return mod(x, domain_label)
    return mod(x)


def _act(name):
    if name == "relu":
        return F.relu
    return lambda x: F.leaky_relu(x, 0.01)


def _nchw(x):
    return x.float().permute(0, 3, 1, 2)


def _nhwc(x):
    return x.float().permute(0, 2, 3, 1)


class _Zoo(nn.Module):
    def init_weights_(self, generator):
        """The JAX package's init (unet2d.py:23-34), drawn from
        `generator`; normalisation layers keep weight 1 and bias 0."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                kaiming_normal_out_(mod.weight, generator)
                fan = mod.out_channels * mod.kernel_size[0] \
                    * mod.kernel_size[1]
                torch_bias_init_(mod.bias, fan, generator)
        return self


class ConvD(spatial.SlabAware):
    """Down block (unet.py:32-73): [maxpool] -> conv-norm -> conv-norm-act
    -> conv-norm-act. The first conv's output skips the activation. On a
    row slab the 3x3 convolutions take halo rows."""

    def __init__(self, inplanes, planes, norm="bn", first=False,
                 activation="relu", num_domains=None):
        super().__init__()
        self.first = first
        self.act = _act(activation)
        self.conv1 = _conv(inplanes, planes, 3)
        self.bn1 = normalization(planes, norm, num_domains)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = normalization(planes, norm, num_domains)
        self.conv3 = _conv(planes, planes, 3)
        self.bn3 = normalization(planes, norm, num_domains)

    def forward(self, x, domain_label=None, **gkw):
        sizes = gkw.get("group_sizes")
        mesh = spatial.slab_mesh(self, sizes)
        if not self.first:
            x = F.max_pool2d(x, 2)

        def conv(mod, t):
            return spatial.conv(mod, t, mesh, sizes)
        x = _norm(self.bn1, conv(self.conv1, x), domain_label, gkw)
        y = self.act(_norm(self.bn2, conv(self.conv2, x), domain_label, gkw))
        return self.act(_norm(self.bn3, conv(self.conv3, y), domain_label,
                              gkw))


class ConvU(spatial.SlabAware):
    """Up block (unet.py:75-118): [conv-norm-act] -> upsample x2 -> 1x1
    conv-norm-act -> concat [prev, y] -> conv-norm-act. On a row slab the
    3x3 convolutions and the upsampling take halo rows."""

    def __init__(self, planes, norm="bn", first=False, activation="relu",
                 num_domains=None):
        super().__init__()
        self.first = first
        self.act = _act(activation)
        if not first:
            self.conv1 = _conv(2 * planes, planes, 3)
            self.bn1 = normalization(planes, norm, num_domains)
        self.conv2 = _conv(planes, planes // 2, 1)
        self.bn2 = normalization(planes // 2, norm, num_domains)
        self.conv3 = _conv(planes, planes, 3)
        self.bn3 = normalization(planes, norm, num_domains)

    def forward(self, x, prev, domain_label=None, **gkw):
        sizes = gkw.get("group_sizes")
        mesh = spatial.slab_mesh(self, sizes)
        if not self.first:
            x = self.act(_norm(self.bn1, spatial.conv(self.conv1, x, mesh,
                                                      sizes),
                               domain_label, gkw))
        y = spatial.upsample2x(x, mesh, sizes)
        y = self.act(_norm(self.bn2, self.conv2(y), domain_label, gkw))
        y = torch.cat([prev, y], dim=1)
        return self.act(_norm(self.bn3, spatial.conv(self.conv3, y, mesh,
                                                     sizes),
                              domain_label, gkw))


class ConvURec(nn.Module):
    """Reconstruction up block (unet.py:120-166): conv-norm-act to
    planes/2, upsample x2, 1x1 conv-norm-act, conv-norm-act."""

    def __init__(self, planes, norm="bn", activation="relu",
                 num_domains=None):
        super().__init__()
        self.act = _act(activation)
        half = planes // 2
        self.conv1 = _conv(planes, half, 3)
        self.bn1 = normalization(half, norm, num_domains)
        self.conv2 = _conv(half, half, 1)
        self.bn2 = normalization(half, norm, num_domains)
        self.conv3 = _conv(half, half, 3)
        self.bn3 = normalization(half, norm, num_domains)

    def forward(self, x, domain_label=None, **gkw):
        x = self.act(_norm(self.bn1, self.conv1(x), domain_label, gkw))
        y = spatial.upsample2x(x)
        y = self.act(_norm(self.bn2, self.conv2(y), domain_label, gkw))
        return self.act(_norm(self.bn3, self.conv3(y), domain_label, gkw))


class _Unet2DBase(_Zoo):
    """The shared encoder (convd1..5, widths n..16n) and decoder
    (convu4..1) of unet2d.py:168-215."""

    def __init__(self, c=3, n=16, norm="bn", activation="relu",
                 num_domains=None, encoder=True, decoder=True):
        super().__init__()
        kw = dict(norm=norm, activation=activation, num_domains=num_domains)
        if encoder:
            self.convd1 = ConvD(c, n, first=True, **kw)
            self.convd2 = ConvD(n, 2 * n, **kw)
            self.convd3 = ConvD(2 * n, 4 * n, **kw)
            self.convd4 = ConvD(4 * n, 8 * n, **kw)
            self.convd5 = ConvD(8 * n, 16 * n, **kw)
        if decoder:
            self.convu4 = ConvU(16 * n, first=True, **kw)
            self.convu3 = ConvU(8 * n, **kw)
            self.convu2 = ConvU(4 * n, **kw)
            self.convu1 = ConvU(2 * n, **kw)

    def _encode(self, x, **kw):
        x1 = self.convd1(x, **kw)
        x2 = self.convd2(x1, **kw)
        x3 = self.convd3(x2, **kw)
        x4 = self.convd4(x3, **kw)
        return x1, x2, x3, x4, self.convd5(x4, **kw)

    def _decode(self, feats, **kw):
        x1, x2, x3, x4, x5 = feats
        y4 = self.convu4(x5, x4, **kw)
        y3 = self.convu3(y4, x3, **kw)
        y2 = self.convu2(y3, x2, **kw)
        return self.convu1(y2, x1, **kw), y2, y3, y4


class Unet2D(_Unet2DBase, spatial.SlabAware):
    """unet.py:168-203."""

    def __init__(self, c=3, n=16, norm="bn", num_classes=2,
                 activation="relu", num_domains=None):
        super().__init__(c, n, norm, activation, num_domains)
        self.seg1 = _conv(2 * n, num_classes, 3)

    def forward(self, x, domain_label=None, groups=1, group_sizes=None,
                group_valid=None):
        """x: (B, H, W, c) NHWC -> f32 logits (B, H, W, num_classes)."""
        kw = dict(domain_label=domain_label, groups=groups,
                  group_sizes=group_sizes, group_valid=group_valid)
        y1 = self._decode(self._encode(_nchw(x), **kw), **kw)[0]
        return _nhwc(spatial.conv(self.seg1, y1,
                                  spatial.slab_mesh(self, group_sizes),
                                  group_sizes))


class Unet2D_MT(_Unet2DBase):
    """Segmentation and reconstruction heads (unet.py:206-246); both
    always exist, `is_rec` picks the output."""

    def __init__(self, c=3, n=16, norm="bn", num_classes=2,
                 activation="relu"):
        super().__init__(c, n, norm, activation)
        self.seg1 = _conv(2 * n, num_classes, 3)
        self.rec1 = _conv(2 * n, c, 3)

    def forward(self, x, is_rec=False):
        y1 = self._decode(self._encode(_nchw(x)))[0]
        return _nhwc(self.rec1(y1) if is_rec else self.seg1(y1))


class Encoder(_Unet2DBase):
    """unet.py:248-271: the five encoder features, NHWC."""

    def __init__(self, c=3, n=16, norm="bn", activation="relu"):
        super().__init__(c, n, norm, activation, decoder=False)

    def forward(self, x):
        return [_nhwc(f) for f in self._encode(_nchw(x))]


class Decoder(_Unet2DBase):
    """unet.py:273-296: the decoder on the five NHWC encoder features."""

    def __init__(self, n=16, num_classes=2, norm="bn", activation="relu"):
        super().__init__(n=n, norm=norm, activation=activation,
                         encoder=False)
        self.out1 = _conv(2 * n, num_classes, 3)

    def forward(self, feats):
        y1 = self._decode([_nchw(f) for f in feats])[0]
        return _nhwc(self.out1(y1))


class RecDecoder(_Zoo):
    """DSBN-conditionable reconstruction decoder (unet.py:339-364)."""

    def __init__(self, n=16, num_classes=2, norm="bn", activation="relu",
                 num_domains=None):
        super().__init__()
        kw = dict(norm=norm, activation=activation, num_domains=num_domains)
        self.convu4 = ConvURec(16 * n, **kw)
        self.convu3 = ConvURec(8 * n, **kw)
        self.convu2 = ConvURec(4 * n, **kw)
        self.convu1 = ConvURec(2 * n, **kw)
        self.out1 = _conv(n, num_classes, 3)

    def forward(self, x, domain_label=None):
        """x: (B, H, W, 16n) NHWC -> (B, 16H, 16W, num_classes)."""
        y = _nchw(x)
        for block in (self.convu4, self.convu3, self.convu2, self.convu1):
            y = block(y, domain_label=domain_label)
        return _nhwc(self.out1(y))


class Unet2D_DS(_Unet2DBase):
    """Deep supervision (unet.py:365-419): side heads at every decoder
    level and on the bottleneck, upsampled to the input size."""

    def __init__(self, c=3, n=16, norm="bn", num_classes=2,
                 activation="relu"):
        super().__init__(c, n, norm, activation)
        for name, width in (("seg1", 2 * n), ("seg2", 4 * n),
                            ("seg3", 8 * n), ("seg4", 16 * n),
                            ("seg5", 16 * n)):
            setattr(self, name, _conv(width, num_classes, 3))

    def forward(self, x, deep_sup=False):
        x = _nchw(x)
        feats = self._encode(x)
        y1, y2, y3, y4 = self._decode(feats)
        y1_pred = _nhwc(self.seg1(y1))
        if not deep_sup:
            return y1_pred

        def up(t):
            return _nhwc(spatial.resize_bilinear(t, *x.shape[2:]))

        return (y1_pred, up(self.seg2(y2)), up(self.seg3(y3)),
                up(self.seg4(y4)), up(self.seg5(feats[4])))


class Unet2D_MS(Unet2D_DS):
    """Multi-scale heads (unet.py:421-471): Unet2D_DS's heads at their own
    resolutions, without upsampling."""

    def forward(self, x, multi_scale_output=False):
        feats = self._encode(_nchw(x))
        y1, y2, y3, y4 = self._decode(feats)
        outs = (self.seg1(y1), self.seg2(y2), self.seg3(y3), self.seg4(y4),
                self.seg5(feats[4]))
        if not multi_scale_output:
            return _nhwc(outs[0])
        return tuple(_nhwc(o) for o in outs)


class Discriminator(_Zoo):
    """PatchGAN-style discriminator (unet.py:473-501): 4x4 convolutions,
    leaky ReLU 0.2, instance norm after c1..c3, global average pool."""

    def __init__(self, input_nc=3, n=16):
        super().__init__()
        self.c0 = _conv(input_nc, n, 4, 2, 1)
        self.c1 = _conv(n, 2 * n, 4, 2, 1)
        self.c2 = _conv(2 * n, 4 * n, 4, 2, 1)
        self.c3 = _conv(4 * n, 8 * n, 4, 1, 1)
        self.c4 = _conv(8 * n, 1, 4, 1, 1)

    def forward(self, x):
        """x: (B, H, W, input_nc) NHWC -> (B, 1)."""
        x = F.leaky_relu(self.c0(_nchw(x)), 0.2)
        for conv in (self.c1, self.c2, self.c3):
            x = F.leaky_relu(F.instance_norm(conv(x), eps=1e-5), 0.2)
        return self.c4(x).mean(dim=(2, 3))
