"""The port's DeepLabV2 on ResNet-50 on a 1 x 4 mesh (4 Gloo ranks on the
CPU, all on the space axis) against the JAX model under
`spatial_constraint` of `make_mesh(4, spatial=4)`, float32, at 64 x 64
(helpers in tests/torch_spatial_zoo.py). Each rank holds one 16-row
block of the input, so 2 of the 8 rows of the stride-8 features: the
ASPP's shared halo of 24 rows takes rows from slabs three ranks away, and
past the image's edges, and the dilated backbone's halos (2 and 4 rows)
from one and two ranks away.

One train-mode call of 3 BN groups of 2 images and the backward of
sum(logits * r), at tests/test_torch_spatial_deeplab.py's bars: logits
at rtol 1e-4 and atol 6e-4, running statistics at rtol/atol 1e-4, with
the ReLUs; every gradient in norm at 1e-3 with every ReLU a tanh in both
packages (no seed of DeepLab-R50 at these BN groups is flip-free: see
that file). The replicas are bit-equal.

Planted control, which must miss the logits' bar: the ASPP's shared
halo zeroed (every slab convolved as if it were the image: at 64 px the
dilation-6 taps reach 3 slabs). The slab-local resize misses in
test_torch_spatial_deeplab.py.
"""

import functools

import pytest

import torch_spatial_zoo as tz

S, WORLD, SPATIAL, SEED = 64, 4, 4, 0
RUNS = {fault: ("r50", SEED, S, fault)
        for fault in (None, "smooth", "aspp_zero")}


@functools.lru_cache(maxsize=None)
def ranks():
    return tz.port_runs(tuple(RUNS.values()), WORLD, SPATIAL)


@pytest.mark.parametrize("smooth", [False, True])
def test_deeplab_on_1x4_mesh_matches_jax(smooth):
    run = RUNS["smooth" if smooth else None]
    tz.check_against_jax(ranks()[run], "r50", SEED, S, WORLD, SPATIAL,
                         grad_rtol=1e-3 if smooth else None, smooth=smooth)


def test_planted_aspp_zero_misses_the_bar():
    assert tz.misses_y_bar(ranks()[RUNS["aspp_zero"]], "r50", SEED, S,
                           WORLD, SPATIAL)
