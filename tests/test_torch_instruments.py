"""The port trainer's instruments against the JAX trainer's, on the CPU:

  * UST_WNORM_LOG (trainer.py:351-370): on a UNet whose weights are
    converted from JAX variables (drawn with numpy from a seed), the
    port's weight health gives the JAX lines' module names, order and
    values (trainer.py:358-361 applied to the same variables) to 1e-6
    relative, and the same two log lines; BN's `num_batches_tracked`
    stays out of the bn line;
  * `--profile_dir` (trainer.py:253-261): torch.profiler runs over steps 2
    and 3 of the first epoch and no other, and its Chrome trace lands in
    the directory with its path logged.
"""

import json
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import unet_pair
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.engine.trainer import Trainer as JaxTrainer
from ust_run_tpu_torch import train
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.engine import trainer as trainer_mod

pytestmark = pytest.mark.usefixtures("single_thread")


def _jax_module_max(tree):
    """trainer.py:358-361."""
    return {k: float(max(jnp.max(jnp.abs(x)) for x in jax.tree.leaves(v)))
            for k, v in tree.items()}


def test_weight_health_matches_jax(caplog):
    _, variables, net = unet_pair(3, 2, 0, 0, 32, seed=5)
    for name, b in net.named_buffers():
        if name.endswith("num_batches_tracked"):
            b.fill_(10 ** 6)            # a count, larger than any weight
    params, bn = trainer_mod.weight_health(net)
    want_p = _jax_module_max(variables["params"])
    want_b = _jax_module_max(variables["batch_stats"])
    assert list(params) == list(want_p) == [
        "down1", "down2", "down3", "down4", "inc", "outc", "up1", "up2",
        "up3", "up4"]
    assert list(bn) == list(want_b) == [k for k in want_p if k != "outc"]
    for got, want in ((params, want_p), (bn, want_b)):
        np.testing.assert_allclose([got[k] for k in want],
                                   [want[k] for k in want], rtol=1e-6)

    caplog.set_level(logging.INFO)
    jax_self = types.SimpleNamespace(state=types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"]))
    JaxTrainer._log_weight_health(jax_self, 2)
    trainer_mod.log_weight_health(2, net)
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 4 and lines[:2] == lines[2:]
    assert lines[0].startswith("epoch 3 weight health: params max down1:")
    assert lines[1].startswith("epoch 3 weight health: bn max down1:")


def test_profile_dir_traces_steps_two_and_three(tmp_path, monkeypatch,
                                                caplog):
    root = generate("fundus", str(tmp_path / "data"), n_train=5, n_test=1,
                    size=32, seed=0)
    profiled = []
    step_fn = trainer_mod.step_fn

    def recording_step(*a, **kw):
        profiled.append(torch.autograd.profiler._is_profiler_enabled)
        return step_fn(*a, **kw)

    monkeypatch.setattr(trainer_mod, "step_fn", recording_step)
    caplog.set_level(logging.INFO)
    out = tmp_path / "prof"
    train.main(["--dataset", "fundus", "--data_root", root, "--lb_num", "3",
                "--patch_override", "32", "--eval_batch", "2",
                "--domain_num", "1", "--max_iterations", "4",
                "--num_eval_iter", "4", "--model_root", str(tmp_path / "m"),
                "--save_name", "p", "--device", "cpu", "--profile_dir",
                str(out)])
    assert profiled == [False, True, True, False]
    path = out / "trace_rank0.json"
    assert f"profiler trace written to {path}" in caplog.text
    events = json.load(open(path))["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "aten::convolution" in names and "aten::sigmoid" in names
