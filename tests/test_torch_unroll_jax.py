"""What the port's K-step call stands for, in the JAX package: its
make_train_multi_step (a lax.scan of the step) at K = 2 on the CPU gives
the metric rows and the state of its own two single steps, and its packed
metric layout (`metric_spec`) is the port's, which the port's trainer
drains K rows of as JAX's does. Patch 32, batch 2+2, fundus, float32.
The scan and the single step are two XLA programs, so their rows are held
to rtol 1e-5 (atol 1e-6), not bit for bit. Compiling both programs takes
about a minute on the CPU, so that test is marked slow; the layout test
compiles nothing."""

import dataclasses

import jax
import numpy as np
import pytest

from torch_unroll import hp_for
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.models import UNet as JaxUNet
from ust_run_tpu.semisup import create_train_state
from ust_run_tpu.semisup.step import HyperParams as JaxHP
from ust_run_tpu.semisup.step import (make_train_multi_step, make_train_step,
                                      metric_spec, unpack_metrics)
from ust_run_tpu_torch.semisup import step as pstep

pytestmark = pytest.mark.usefixtures("single_thread")

K = 2


def _data(hp, r, n=6):
    lab = r.choice([0, 128, 255], (n, hp.patch, hp.patch, 1)).astype(np.uint8)
    return {"lb_img": r.randint(0, 256, (n, hp.patch, hp.patch, hp.channels))
            .astype(np.uint8), "lb_lab": lab,
            "ulb_img": r.randint(0, 256, (n, hp.patch, hp.patch,
                                          hp.channels)).astype(np.uint8),
            "ulb_lab": lab[::-1].copy(),
            "ulb_dc": np.asarray([1, 2] * (n // 2), np.int32)}


@pytest.mark.parametrize("dataset", ["fundus", "BUSI"])
def test_port_metric_layout_is_jax(dataset):
    """The packed row's layout, and both unpackings of one row."""
    hp = hp_for(dataset)
    jhp = JaxHP(**dataclasses.asdict(hp))
    assert metric_spec(jhp) == pstep.metric_spec(hp)
    width = sum(n for _, n in metric_spec(jhp))
    row = np.random.RandomState(1).uniform(size=width).astype(np.float32)
    got, want = pstep.unpack_metrics(row, hp), unpack_metrics(row, jhp)
    assert list(got) == list(want)
    for k in want:
        assert np.shape(got[k]) == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k], want[k], k)


@pytest.mark.slow
def test_jax_multi_step_is_its_single_steps():
    hp = hp_for("fundus")
    jhp = JaxHP(**dataclasses.asdict(hp))
    model = JaxUNet(n_channels=jhp.channels, n_classes=jhp.num_classes)
    r = np.random.RandomState(0)
    data = _data(jhp, r)
    batches = [{"lb_idx": r.randint(0, 6, 2).astype(np.int32),
                "ulb_idx": r.randint(0, 6, 2).astype(np.int32)}
               for _ in range(K)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    multi_state, rows = make_train_multi_step(model, jhp)(
        create_train_state(model, jhp, seed=0), data, stacked)
    rows = np.asarray(rows)
    assert rows.shape == (K, sum(n for _, n in pstep.metric_spec(hp)))

    single = make_train_step(model, jhp)
    state = create_train_state(model, jhp, seed=0)
    want = []
    for b in batches:
        state, m = single(state, data, b)
        want.append(np.asarray(m))
    for j in range(K):
        got, exp = unpack_metrics(rows[j], jhp), unpack_metrics(want[j], jhp)
        for k in got:
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"row {j} {k}")
    assert int(multi_state.step) == int(state.step) == K
    for a, b in zip(jax.tree.leaves(multi_state.params),
                    jax.tree.leaves(state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
