"""The DeepLabV2-R50 train step on a mesh with a space axis, on the CPU,
float32 (Unet2D's is in test_torch_spatial_zoo_step.py).

`--model deeplabv2_r50`, fundus at patch 32 (batch 2+2), on 2 ranks as
1 x 2 (each rank 16 of the 32 rows: 8 after the stem, 2 at the stride-8
stages, where the ASPP's 24-row halo takes all the other rank's rows),
against the port's single-process step, two steps on the seeded feed of
tests/torch_dist.py: the first step's loss terms at rtol 1e-5, its
gradient (the SGD momentum after it) at 1e-3 of each tensor's norm, the
replicas bit-equal after both. A whole JAX step through ResNet-50
compiles too long for this tier (tests/test_torch_zoo_step.py says so),
so the port's single-process step, which tests/test_torch_zoo.py holds
to JAX's modules, stands in for it. Both runs have every ReLU a tanh: at
these BN groups (1-2 images of 4 x 4 pixels at the stride-8 stages) each
of seeds 3-5 flips a ReLU between the slab sums and the whole-image
means and moves some gradient past the bar, as DeepLab's model test
finds for every seed (test_torch_spatial_deeplab.py); with tanh, seed 3
meets it.
"""

import numpy as np
import pytest

import torch_dist as td
from torch_threads import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")


def test_deeplab_r50_step_on_1x2_matches_one_process(tmp_path):
    args = (td.hyperparams("fundus", 32), 3, 0, 0.1, "deeplabv2_r50")
    res = td.run_ranks(tmp_path, 2, td.run_steps_smooth, *args, spatial=2)
    with td.one_thread():
        one = td.run_steps_smooth(None, *args)
    assert [r["replica_diff"] for r in res] == [0.0, 0.0]
    np.testing.assert_allclose(res[0]["metrics"][0][:5],
                               one["metrics"][0][:5], rtol=1e-5)
    errs = td.norm_errs(res[0]["first_grad"], one["first_grad"])
    assert max(errs.values()) < 1e-3, max(errs.items(), key=lambda e: e[1])
