"""The train step with a per-step feed (semisup/step.py: `draw_feed`, then
the body on device tensors, the state written in place) against the step
as it ran before it (tests/torch_step_reference.py: host scalars, draws
where they are used, the state rebound), on the CPU at patch 32, batch
2+2, float32, with narrow Unet2Ds (tests/torch_unroll.py): from the same
state, generators and index rows, three steps with an epoch boundary
before the third (the LQ reset and the end of the epoch-0 hardness
forcing) give the same metric rows and the same state, bit for bit, for
fundus (multilabel) and BUSI (softmax)."""

import pytest
import torch

import torch_step_reference as reference
from torch_unroll import (assert_states_equal, corpus, hp_for, index_rows,
                          new_state, single_thread)  # noqa: F401
from ust_run_tpu_torch.semisup import step as pstep
from ust_run_tpu_torch.semisup.state import reset_epoch

pytestmark = pytest.mark.usefixtures("single_thread")


@pytest.mark.parametrize("dataset", ["fundus", "BUSI"])
def test_feed_step_is_the_reference_step(dataset):
    hp = hp_for(dataset)
    data = corpus(hp, 3)
    ref, new = new_state(hp, 5), new_state(hp, 5)
    assert_states_equal(ref, new)
    for i, idx in enumerate(index_rows(7, 3, hp)):
        if i == 2:
            for st in (ref, new):
                reset_epoch(st, 1)
        want = reference.step_fn(ref, data, idx, hp)
        got = pstep.step_fn(new, data, idx, hp)
        assert torch.equal(got, want), (i, (got - want).abs().max())
    assert_states_equal(ref, new)
    assert new.step == 3 and bool(new.queue.valid.any())
