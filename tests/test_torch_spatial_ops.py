"""The zoo's operations on a row slab (ust_run_tpu_torch/parallel/
spatial.py) against the same operations on the whole image, on Gloo
ranks on the CPU, float32: 2 ranks holding 2 + 1 blocks of 16 rows of a
48 x 32 image, and 4 ranks holding one block each of a 64 x 48 image
(non-square, so that each layer's global height comes from the width's
scale). Each operation runs at the layer where the zoo runs it, as a
slab of that layer's rows (the input's blocks scaled):

  * the ResNet stem, 7x7 stride 2 padding 3 (halo 3 above, 2 below);
  * a stride-2 3x3 (layer2's first block) at 1/4;
  * dilated 3x3 convolutions at 2, 4 and 24 at 1/8, where a slab holds
    2-4 rows and the halo reaches several slabs away or past the image;
  * the 3x3 stride-2 max pool at 1/2 on an input with negative values;
  * Unet2D's bilinear x2 upsampling (align_corners=False) at 1/16;
  * DeepLab's x8 align-corners resize from 1/8 to the input's size.

Outputs, input gradients and (for convolutions) weight gradients summed
over the ranks of a seeded loss sum(y * r) are held to the whole-image
operation at rtol 1e-5 and an absolute floor of 1e-6 of the reference's
largest magnitude: float32 rounding of differently ordered sums (the
convolution of a haloed slab may take another algorithm than the whole
image's, and the resize is two matrix products where the whole image's
is F.interpolate); the halo itself is a copy (test_torch_spatial_halo.py).

Planted faults, each of which must miss the output's bar: zeros instead
of -inf past the image's edges in front of the max pool (its input is
negative, so a zero wins the window), zeros instead of the edge row in
upsample2x's halo, and the x8 resize by F.interpolate(align_corners=True)
on the slab, which maps the slab's corners instead of the image's.
"""

import functools
import pathlib
import shutil
import tempfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import torch_dist as td
from ust_run_tpu_torch.models.deeplab import resize_align_corners
from ust_run_tpu_torch.parallel import GroupSizes, spatial

IMAGES = {2: (48, 32), 4: (64, 48)}           # space -> input (H, W)
N = 2


def _conv(cin, cout, k, stride=1, dilation=1, bias=False, seed=0):
    torch.manual_seed(seed)
    return nn.Conv2d(cin, cout, k, stride=stride, dilation=dilation,
                     padding=dilation * (k // 2), bias=bias)


# name -> (input level: H // level, channels, output level, whole-image
# operation, slab operation(x, mesh, sizes, out rows, out width))
def _ops():
    stem, s2 = _conv(3, 8, 7, stride=2), _conv(4, 6, 3, stride=2, seed=1)
    dil = {d: _conv(4, 5, 3, dilation=d, bias=True, seed=d)
           for d in (2, 4, 24)}
    out = {
        "stem": (1, 3, 2, stem, lambda x, m, s, h, w:
                 spatial.conv(stem, x, m, s)),
        "stride2": (4, 4, 8, s2, lambda x, m, s, h, w:
                    spatial.conv(s2, x, m, s)),
        "maxpool": (2, 4, 4, lambda x: F.max_pool2d(x, 3, 2, 1),
                    lambda x, m, s, h, w: spatial.max_pool2d(x, 3, 2, 1, m,
                                                             s)),
        "upsample2x": (16, 4, 8, spatial.upsample2x,
                       lambda x, m, s, h, w: spatial.upsample2x(x, m, s)),
        "resize8": (8, 2, 1, None,
                    lambda x, m, s, h, w: spatial.resize_align_corners(
                        x, h, w, m, s)),
    }
    for d, c in dil.items():
        out[f"dilated{d}"] = (8, 4, 8, c, lambda x, m, s, h, w, c=c:
                              spatial.conv(c, x, m, s))
    return out


OPS = sorted(_ops())


def _inputs(name, space):
    level, c, out_level, *_ = _ops()[name]
    hh, ww = IMAGES[space]
    g = torch.Generator().manual_seed(len(name) + space)
    x = torch.randn((N, c, hh // level, ww // level), generator=g)
    if name == "maxpool":
        x = x - 3.0                        # mostly negative, as no ReLU'd
    return x, (hh // out_level, ww // out_level)


def _whole(name, x, out_hw):
    op = _ops()[name][3]
    return resize_align_corners(x, *out_hw) if op is None else op(x)


def _rows(mesh, sizes, w):
    return slice(*spatial.layout(mesh, sizes, w)[mesh.space_index])


FAULTS = {2: (None,), 4: (None, "pool_zeros", "upsample_zeros",
                         "local_resize")}


def run_ops(mesh):
    """Every operation on this rank's rows, with each of FAULTS planted:
    {fault: {name: (output rows, input gradient rows, weight gradient
    share or None)}}."""
    return {fault: run_faulted(mesh, fault) for fault in FAULTS[mesh.space]}


def run_faulted(mesh, fault):
    hh, ww = IMAGES[mesh.space]
    sizes = GroupSizes((N,), (N,), hh, ww)
    res = {}
    with td.planted_slab(fault):
        for name in OPS:
            x, (ho, wo) = _inputs(name, mesh.space)
            op = _ops()[name]
            xs = x[:, :, _rows(mesh, sizes, x.shape[3])].clone() \
                .requires_grad_()
            out_rows = _rows(mesh, sizes, wo)
            y = op[4](xs, mesh, sizes, out_rows.stop - out_rows.start, wo)
            g = torch.Generator().manual_seed(99)
            r = torch.randn((N, y.shape[1], ho, wo), generator=g)[
                :, :, out_rows]
            (y * r).sum().backward()
            wgrad = op[3].weight.grad.clone() \
                if isinstance(op[3], nn.Conv2d) else None
            if wgrad is not None:
                op[3].weight.grad = None
            res[name] = (y.detach(), xs.grad, wgrad)
    return res


@functools.lru_cache(maxsize=None)
def op_runs(space):
    tmp = pathlib.Path(tempfile.mkdtemp())
    try:
        return td.run_ranks(tmp, space, run_ops, spatial=space)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def reference(name, space):
    x, out_hw = _inputs(name, space)
    x.requires_grad_()
    y = _whole(name, x, out_hw)
    g = torch.Generator().manual_seed(99)
    r = torch.randn(y.shape, generator=g)
    (y * r).sum().backward()
    op = _ops()[name][3]
    return y.detach(), x.grad, op.weight.grad \
        if isinstance(op, nn.Conv2d) else None


def _close(got, want, what):
    floor = 1e-6 * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=floor, err_msg=what)


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("name", OPS)
def test_slab_op_matches_whole_image(name, space):
    y, gx, gw = reference(name, space)
    ranks = [r[None] for r in op_runs(space)]
    _close(torch.cat([r[name][0] for r in ranks], dim=2), y, "output")
    _close(torch.cat([r[name][1] for r in ranks], dim=2), gx,
           "input gradient")
    if gw is not None:
        _close(sum(r[name][2] for r in ranks), gw, "weight gradient")


@pytest.mark.parametrize("fault,name", [("pool_zeros", "maxpool"),
                                        ("upsample_zeros", "upsample2x"),
                                        ("local_resize", "resize8")])
def test_planted_fault_misses_the_bar(fault, name):
    y, *_ = reference(name, 4)
    got = torch.cat([r[fault][name][0] for r in op_runs(4)], dim=2)
    floor = 1e-6 * float(y.abs().max())
    assert not np.allclose(got.numpy(), y.numpy(), rtol=1e-5, atol=floor)
