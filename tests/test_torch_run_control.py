"""The port trainer's run control against the JAX trainer's, on the CPU at
patch 32:

  * UST_STOP_AFTER_ITERS (trainer.py:315-323): the train entry stops after
    the first epoch that reaches N, with the evaluation and checkpoint of
    each epoch and the JAX log line, and `max_iterations` stays the full
    budget: the lr it logs equals the JAX schedule (HyperParams of the JAX
    config, state.py:74-76) at the same iteration, float32, rtol 1e-6;
  * the tqdm bar (trainer.py:242-251, 391-412): drawn on a terminal only,
    its description the JAX trainer's `_bar_desc` string for the same
    metrics, for fundus and for the other profiles;
  * `cli.bootstrap` removes a stale `<snapshot>/code` as the JAX bootstrap
    does (cli.py:77-78).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.config import TrainConfig as JaxConfig
from ust_run_tpu.engine.trainer import Trainer as JaxTrainer
from ust_run_tpu.semisup import HyperParams as JaxHP
from ust_run_tpu_torch import train
from ust_run_tpu_torch.cli import bootstrap
from ust_run_tpu_torch.config import build_parser
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.engine import trainer as trainer_mod

pytestmark = pytest.mark.usefixtures("single_thread")


class RecordingWriter:
    """Stands in for the metric writer: records every scalar."""
    scalars = []

    def __init__(self, logdir):
        pass

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def close(self):
        pass


def _argv(tmp_path, *extra):
    root = generate("fundus", str(tmp_path / "data"), n_train=5, n_test=1,
                    size=32, seed=0)
    return ["--dataset", "fundus", "--data_root", root, "--lb_num", "3",
            "--patch_override", "32", "--eval_batch", "2", "--domain_num",
            "1", "--model_root", str(tmp_path / "m"), "--save_name", "s",
            "--overwrite", "--device", "cpu", *extra]


def test_stop_after_iters_keeps_the_full_budget(tmp_path, monkeypatch):
    monkeypatch.setenv("UST_STOP_AFTER_ITERS", "4")
    monkeypatch.setattr(trainer_mod, "MetricWriter", RecordingWriter)
    RecordingWriter.scalars = []
    tr = train.main(_argv(tmp_path, "--num_eval_iter", "2"))
    assert tr.state.step == 4 and tr.cfg.max_iterations == 30000
    log = open(tmp_path / "m" / "fundus" / "s" / "log.txt").read()
    assert "UST_STOP_AFTER_ITERS=4 reached at iter 4; stopping early" in log
    assert "15000 epoch in all." in log
    assert "epoch 2:" in log and "epoch 3:" not in log
    for tag in ("test ema model", "test stu model", "save checkpoint to"):
        assert log.count(tag) == 2, tag

    jhp = JaxHP.from_config(JaxConfig(dataset="fundus").resolve())
    assert jhp.max_iterations == 30000
    lrs = {it: v for tag, v, it in RecordingWriter.scalars
           if tag == "train/lr"}
    assert sorted(lrs) == [2, 4]
    for it, lr in lrs.items():
        # the update of iteration `it` runs at step it - 1 (step.py:549-551)
        eff = jnp.maximum(jnp.float32(it - 1) - 1, 0)
        want = jhp.base_lr * (1.0 - eff / jhp.max_iterations) ** 0.9
        np.testing.assert_allclose(lr, float(want), rtol=1e-6)
    # what a run cut by --max_iterations 4 would have used instead
    assert abs(lrs[4] - 0.03 * (1 - 2 / 4) ** 0.9) > 1e-3


@pytest.mark.parametrize("dataset", ["fundus", "BUSI"])
def test_bar_description_matches_jax(dataset):
    rng = np.random.RandomState(0)
    m = {k: np.float32(rng.rand()) for k in (
        "loss", "sup_loss", "unsup_loss_ul", "unsup_loss_lu", "unsup_loss_s",
        "consistency_weight", "mask_ratio", "ratio_before_ensemble",
        "ratio_after_ensemble")}
    m["ulb_dice"] = rng.rand(2 if dataset == "fundus" else 1) \
        .astype(np.float32)
    jax_self = types.SimpleNamespace(
        cfg=types.SimpleNamespace(dataset=dataset))
    assert trainer_mod.bar_description(dataset, 17, m) == \
        JaxTrainer._bar_desc(jax_self, 17, m)


def test_progress_bar_on_a_terminal_only(tmp_path, monkeypatch, capsys):
    argv = _argv(tmp_path, "--num_eval_iter", "2", "--max_iterations", "2")
    tr = train.main(argv)
    assert tr._bar is None and "iteration 1: loss:" not in \
        capsys.readouterr().err
    monkeypatch.setattr(trainer_mod.sys.stdout, "isatty", lambda: True)
    train.main(argv)
    assert "iteration 1: loss:" in capsys.readouterr().err


def test_bootstrap_removes_a_stale_code_dir(tmp_path):
    code = tmp_path / "fundus" / "s" / "code"
    code.mkdir(parents=True)
    bootstrap(build_parser().parse_args(
        ["--dataset", "fundus", "--model_root", str(tmp_path), "--save_name",
         "s", "--overwrite"]), __file__)
    assert not code.exists()
