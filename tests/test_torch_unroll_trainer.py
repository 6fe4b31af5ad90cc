"""The trainer at `--unroll_steps 2` against `--unroll_steps 1` on the CPU
(`--model unet2d`, patch 32, epochs of 2 iterations): K = 2 divides
num_eval_iter, so each call runs two steps (`semisup.step.multi_step`,
eager bodies on the CPU) and its two metric rows are drained one call
behind. The run writes the same log lines (all but the epoch's it/s and
images/s, its stage times and the echo of the flags) and ends in the same state, bit for
bit, and so does a `--load` resume of each run; the K rule is JAX's
(trainer.py:113-115)."""

import logging
import re

import pytest

from torch_unroll import assert_states_equal, single_thread  # noqa: F401
from ust_run_tpu_torch import train
from ust_run_tpu_torch.config import TrainConfig
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.engine import trainer as trainer_mod

pytestmark = pytest.mark.usefixtures("single_thread")

_STAMP = re.compile(r"^\[[^\]]*\]\s*")


def _argv(root, model_root, unroll, *extra):
    return ["--dataset", "fundus", "--data_root", root, "--lb_num", "3",
            "--patch_override", "32", "--eval_batch", "2", "--domain_num",
            "1", "--num_eval_iter", "2", "--model_root", model_root,
            "--save_name", "s", "--device", "cpu", "--unroll_steps",
            str(unroll), *extra, "--model", "unet2d"]


def _lines(model_root):
    """log.txt without timestamps, timing lines, the flags' echo and the
    run's own path."""
    text = open(f"{model_root}/fundus/s/log.txt").read()
    lines = [_STAMP.sub("", ln).replace(model_root, "ROOT")
             for ln in text.splitlines()]
    return [ln for ln in lines if ln.strip() and " it/s, " not in ln
            and " stages, device ms a step: " not in ln
            and not ln.startswith("Namespace(")]


def _train(argv):
    """train.main(argv), its log handlers taken off the root logger after
    (the entry adds a file handler per run)."""
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        return train.main(argv)
    finally:
        for h in root.handlers[len(before):]:
            root.removeHandler(h)
            h.close()


@pytest.mark.parametrize("k,num_eval_iter,want", [
    (10, 500, 10), (10, 25, 1), (2, 2, 2), (1, 2, 1), (0, 2, 1)])
def test_unroll_rule_is_jax(k, num_eval_iter, want):
    cfg = TrainConfig(unroll_steps=k, num_eval_iter=num_eval_iter)
    assert trainer_mod.unroll_of(cfg) == want


def test_unroll_two_logs_and_resumes_as_unroll_one(tmp_path):
    root = generate("fundus", str(tmp_path / "data"), n_train=5, n_test=1,
                    size=32, seed=0)
    runs = {}
    for unroll in (1, 2):
        mr = str(tmp_path / f"m{unroll}")
        tr = _train(_argv(root, mr, unroll, "--max_iterations", "4",
                               "--overwrite"))
        assert tr.unroll == unroll and tr.state.step == 4
        runs[unroll] = (mr, tr)
    (mr1, one), (mr2, two) = runs[1], runs[2]
    assert _lines(mr2) == _lines(mr1)
    assert "iteration 4 : loss" in "\n".join(_lines(mr1))
    assert_states_equal(one.state, two.state)

    resumed = {}
    for unroll, (mr, _) in runs.items():
        resumed[unroll] = _train(_argv(root, mr, unroll, "--load",
                                        "--max_iterations", "6"))
        assert resumed[unroll].state.step == 6
    assert _lines(mr2) == _lines(mr1)
    assert "Models restored from epoch 2" in "\n".join(_lines(mr2))
    assert_states_equal(resumed[1].state, resumed[2].state)
