"""The port's Unet2D (norm 'bn') on a 2 x 2 mesh (4 Gloo ranks on the
CPU: data 2 x space 2) against the JAX Unet2D under `spatial_constraint`
of `make_mesh(4, spatial=2)`, float32, the weights carried by
ust_run_tpu_torch.convert (helpers in tests/torch_spatial_zoo.py).

One train-mode call of 3 BN groups of 2 images at 48 x 48 (each data
index holds one image of each group; the space axis cuts the 3 blocks of
16 rows as 2 + 1: 32 and 16 rows, 2 and 1 at the bottom level), and the
backward of sum(logits * r). Every 3x3 convolution (bias included), the
bilinear x2 upsampling (the edge row repeated past the image) and `seg1`
run on slabs. Bars, tests/test_torch_zoo_unet2d.py's: logits and running
statistics at rtol/atol 1e-4, with the ReLUs; every gradient at 1e-3 in
norm (the step's bar; a conv bias that a BatchNorm follows, zero but for
rounding, below 1e-5 of the largest entry), with every ReLU a tanh in
both packages: with the ReLUs, seeds 0-11 each flip a decision between
the slab sums and JAX (worst gradient 2.4e-3 to 3.9e-2 in norm), with
tanh they read 3.2e-5 to 5.6e-5 (`python tests/torch_spatial_zoo.py
unet2d 48 4 2`). The replicas are bit-equal.

Planted control, which must miss the logits' bar: zeros instead of the
edge row in upsample2x's halo at the image's top and bottom.
"""

import functools

import pytest

import torch_spatial_zoo as tz
from torch_threads import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

S, WORLD, SPATIAL, SEED = 48, 4, 2, 0
RUNS = {fault: ("unet2d", SEED, S, fault)
        for fault in (None, "smooth", "upsample_zeros")}


@functools.lru_cache(maxsize=None)
def ranks():
    return tz.port_runs(tuple(RUNS.values()), WORLD, SPATIAL)


@pytest.mark.parametrize("smooth", [False, True])
def test_unet2d_on_2x2_mesh_matches_jax_2d_mesh(smooth):
    run = RUNS["smooth" if smooth else None]
    tz.check_against_jax(ranks()[run], "unet2d", SEED, S, WORLD, SPATIAL,
                         grad_rtol=1e-3 if smooth else None, smooth=smooth)


def test_planted_upsample_zeros_misses_the_bar():
    assert tz.misses_y_bar(ranks()[RUNS["upsample_zeros"]], "unet2d", SEED,
                           S, WORLD, SPATIAL)
