"""The port's dilated ResNet and DeepLabV2 on a 2 x 2 mesh (4 Gloo ranks
on the CPU: data 2 x space 2) against the JAX models under
`spatial_constraint` of `make_mesh(4, spatial=2)` (the conftest's 8 CPU
devices), float32, the weights carried by ust_run_tpu_torch.convert
(helpers in tests/torch_spatial_zoo.py).

One train-mode call of 3 BN groups of 2 images at 32 x 32 (each data
index holds one image of each group; the space axis cuts the 2 blocks of
16 rows as 16 + 16: 8 rows a rank after the stem, 4 after the pool, 2 at
the stride-8 stages), and the backward of sum(y * r):
  * ResNet at depth (1, 1, 1, 1), which keeps the stem (7x7 stride 2,
    halo 3 above and 2 below), the 3x3 stride-2 max pool (-inf past the
    image), layer2's stride-2 3x3 and the dilated 3x3s at 2 (layer3) and
    4 (layer4); y is c4;
  * DeepLabV2 on ResNet-50; y is the logits, resized x8 on the image's
    global align-corners grid.
The port gathers y over both axes and sums its gradients over the
ranks. Bars, tests/test_torch_zoo.py's: c4 at rtol/atol 1e-4, DeepLab's
logits at rtol 1e-4 and atol 6e-4 (53 convolutions of BN groups of 2
images of 4x4 pixels: float32 rounding alone moves them by up to 1.3e-4
in the JAX package itself), running statistics at rtol/atol 1e-4; every
parameter's gradient in norm at 1e-4 (ResNet, test_torch_zoo.py's bar)
and 1e-3 (DeepLab, the step's). The replicas are bit-equal.

Gradients need seeds at which no ReLU decision flips between the mesh
and JAX (tests/torch_spatial_zoo.py says why and runs the scan). ResNet:
seeds 4, 5, 7 and 9 of 0-9 are flip-free (worst gradient within 5.1e-6
of JAX's); this file uses 4. DeepLab-R50: none of seeds 0-9 is (worst
1.3e-2 to 4.2e-2), so its gradients are held with every ReLU a tanh in
both packages, where seeds 0-2 read 3.9e-4 to 5.3e-4; its logits and
statistics are held with the ReLUs.

Planted control, which must miss the logits' bar: the x8 resize by
F.interpolate(align_corners=True) on the slab. (Zeroing the ASPP's halo
cannot show at 32 px: every dilation reaches past the 4-row feature map,
so only its centre taps see the image; tests/test_torch_spatial_deeplab4
.py plants it at 64 px.)
"""

import functools

import numpy as np
import pytest

import torch_spatial_zoo as tz
from torch_threads import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

S, WORLD, SPATIAL = 32, 4, 2
RUNS = (("resnet", 4, S, None), ("r50", 0, S, None), ("r50", 0, S, "smooth"),
        ("r50", 0, S, "local_resize"))


@functools.lru_cache(maxsize=None)
def ranks():
    return tz.port_runs(RUNS, WORLD, SPATIAL)


def test_resnet_on_2x2_mesh_matches_jax_2d_mesh():
    tz.check_against_jax(ranks()[RUNS[0]], "resnet", 4, S, WORLD, SPATIAL,
                         grad_rtol=1e-4)


@pytest.mark.parametrize("smooth", [False, True])
def test_deeplab_on_2x2_mesh_matches_jax_2d_mesh(smooth):
    run = RUNS[2] if smooth else RUNS[1]
    tz.check_against_jax(ranks()[run], "r50", 0, S, WORLD, SPATIAL,
                         grad_rtol=1e-3 if smooth else None, smooth=smooth)


def test_planted_slab_local_resize_misses_the_bar():
    assert tz.misses_y_bar(ranks()[RUNS[3]], "r50", 0, S, WORLD, SPATIAL)
    assert np.isfinite(ranks()[RUNS[3]]["y"].numpy()).all()
