"""DeepLabV2 on the dilated ResNet (port of ust_run_tpu/models/deeplab.py;
reference networks/deeplabv2.py:9-33 + networks/backbone/base.py:8-45).

The head is four parallel 3x3 convolutions with biases at dilations
6/12/18/24 on the stride-8 features, summed, then resized bilinearly with
align_corners=True back to the input size (two interpolation-matrix
products, as in JAX). `tta=True` is BaseNet's test
augmentation: five scales, each with a horizontal flip, softmax
probabilities summed (base.py:23-45).

Module names are upstream's: `backbone.*` (torchvision's ResNet layout)
and `classifier.{0..3}.*`, which
ust_run_tpu/utils/torch_import.py:124-139 reads. The forward keeps the
UNet's contract: NHWC float32 in, NHWC float32 logits out, channels_last
inside, `groups`/`group_sizes`/`group_valid` forwarded to every
GroupedBatchNorm. It computes in float32 (the JAX package gives the zoo
no compute dtype).

On a mesh with a space axis (a call on a row slab, the backbone's too)
the four ASPP convolutions read one shared halo of the stride-8 features,
as wide as the largest dilation (24 rows: over 2 ranks at 256 px a slab
holds 16, so the halo reaches the next slab but one), and their sum is
resized on the image's global sampling grid
(spatial.resize_align_corners). `tta` runs on whole images only.
"""

import torch
from torch import nn

from ust_run_tpu_torch.models import resnet as resnet_lib
from ust_run_tpu_torch.parallel import spatial

_DILATIONS = (6, 12, 18, 24)


def resize_align_corners(x, h2, w2):
    """NCHW bilinear resize with align_corners=True (deeplab.py:41-49:
    output pixel i samples input position i*(n_in-1)/(n_out-1)), as the
    JAX package computes it: two interpolation-matrix products, the
    matrices made once per size and device (F.interpolate's CUDA backward
    adds with atomics, so its sums change from run to run)."""
    h, w = x.shape[2:]
    if (h, w) == (h2, w2):
        return x
    return spatial.resize_by(
        x, spatial.align_matrix(h2, h, x.device),
        spatial.align_matrix(w2, w, x.device))


class DeepLabV2(spatial.SlabAware):
    def __init__(self, backbone="resnet101", nclass=2, in_channels=3):
        super().__init__()
        self.nclass = nclass
        zoo = {"resnet50": resnet_lib.resnet50,
               "resnet101": resnet_lib.resnet101}
        self.backbone = zoo[backbone](in_channels)
        self.classifier = nn.ModuleList(
            nn.Conv2d(2048, nclass, 3, padding=d, dilation=d, bias=True)
            for d in _DILATIONS)

    def init_weights_(self, generator):
        """The backbone's kaiming-normal init; head weights ~ N(0, 0.01)
        (deeplabv2.py:18-19) with zero biases, drawn from `generator`."""
        self.backbone.init_weights_(generator)
        with torch.no_grad():
            for conv in self.classifier:
                conv.weight.normal_(0.0, 0.01, generator=generator)
                conv.bias.zero_()
        return self

    def base_forward(self, x, **gkw):
        """NCHW f32 -> NCHW f32 logits at the input size."""
        h, w = x.shape[2:]
        c4 = self.backbone(x, **gkw)[-1]
        sizes = gkw.get("group_sizes")
        mesh = spatial.slab_mesh(self, sizes)
        if mesh is None:
            out = self.classifier[0](c4)
            for conv in self.classifier[1:]:
                out = out + conv(c4)
            return resize_align_corners(out, h, w)      # deeplabv2.py:30
        out = spatial.conv_sum(self.classifier, c4, mesh, sizes)
        return spatial.resize_align_corners(out, h, w, mesh, sizes)

    def forward(self, x, groups=1, group_sizes=None, group_valid=None,
                tta=False):
        """x: (B, H, W, C) NHWC -> f32 logits (B, H, W, nclass), or with
        `tta` the summed probabilities of the ten views."""
        x = x.float().permute(0, 3, 1, 2)     # NCHW view, channels_last
        assert not (tta and spatial.slab_mesh(self, group_sizes)), \
            "tta runs on whole images"
        if not tta:
            out = self.base_forward(x, groups=groups, group_sizes=group_sizes,
                                    group_valid=group_valid)
            return out.permute(0, 2, 3, 1)
        h, w = x.shape[2:]
        result = torch.zeros((x.shape[0], self.nclass, h, w),
                             device=x.device)
        for scale in (0.5, 0.75, 1.0, 1.5, 2.0):
            cx = resize_align_corners(x, int(h * scale), int(w * scale))
            out = torch.softmax(self.base_forward(cx), dim=1)
            result = result + resize_align_corners(out, h, w)
            out = torch.softmax(self.base_forward(cx.flip(3)), dim=1).flip(3)
            result = result + resize_align_corners(out, h, w)
        return result.permute(0, 2, 3, 1)
