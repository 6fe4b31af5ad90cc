"""The control of the data-parallel step's bars (test_torch_parallel_
step.py) on the CPU: the loss of plain DDP, the mean of the ranks' local
losses, planted in the port's step on 2 Gloo ranks (tests/torch_dist.py)
must miss the bar that the port meets.
"""

import pytest

import torch_dist as td
from torch_threads import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")


def test_bars_see_the_mean_of_local_losses(tmp_path):
    """Two fundus steps (patch 64, batch 2+2) at world 2 with the mean of
    the ranks' local losses planted: the first step's gradient misses
    test_torch_parallel_step.py's bar of 1e-4 of a tensor's norm by more
    than two orders."""
    hp = td.hyperparams("fundus", 64)
    with td.one_thread():
        ref = td.run_steps(None, hp, 3, 0, 0.1)
    got = td.run_ranks(tmp_path, 2, td.run_steps_local_losses, hp, 3, 0,
                       0.1)[0]
    first = td.norm_errs(got["first_grad"], ref["first_grad"])
    assert max(first.values()) > 1e-2, first
