"""UST_NAN_DEBUG and the port's replay tool (counterparts of the JAX
trainer's forensics, trainer.py:158-166, 266-273, 338-344, 372-389, and of
tools/nan_replay.py), on the CPU at patch 32.

A large `--base_lr` (300) drives the loss non-finite within a few steps
(at step 6 on this corpus). With
UST_NAN_SNAP=2 and epochs of 5 iterations, the failure comes after a
rolling snapshot (not the first one) and the dumped batches cross an
epoch boundary, where the trainer resets the LQ carry. The trainer must
exit with code 3 and write the dump; `python -m
ust_run_tpu_torch.nan_replay` must report the same failing iteration,
reproduce every metric of the steps before it bit for bit (twice: it
runs them again to return to the state before the failing step), write
that state (finite) to `prefail.pt`, name the first module with a
non-finite output and exit 1.
"""

import shutil

import numpy as np
import pytest
import torch

from ust_run_tpu_torch import nan_replay, train
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.engine import trainer as trainer_mod

LR = "300"


def _recording(monkeypatch, module):
    """Every metric row `module.unpack_metrics` returns, in order."""
    rows, unpack = [], module.unpack_metrics

    def record(vec, hp):
        rows.append(unpack(vec, hp))
        return rows[-1]

    monkeypatch.setattr(module, "unpack_metrics", record)
    return rows


def test_nan_dump_and_replay(tmp_path, monkeypatch, capsys):
    root = generate("fundus", str(tmp_path / "data"), n_train=5, n_test=1,
                    size=32, seed=0)
    dump = tmp_path / "nan"
    argv = ["--dataset", "fundus", "--data_root", root, "--lb_num", "3",
            "--patch_override", "32", "--eval_batch", "2", "--domain_num",
            "1", "--num_eval_iter", "5", "--base_lr", LR, "--model_root",
            str(tmp_path / "m"), "--save_name", "n", "--device", "cpu"]
    monkeypatch.setenv("UST_NAN_DEBUG", str(dump))
    monkeypatch.setenv("UST_NAN_SNAP", "2")
    trained = _recording(monkeypatch, trainer_mod)
    try:
        with pytest.raises(SystemExit) as exit_:
            train.main(argv)
        assert exit_.value.code == 3
        fail_it = len(trained)
        assert all(np.isfinite(float(m["loss"])) for m in trained[:-1])
        assert not np.isfinite(float(trained[-1]["loss"]))
        log = open(tmp_path / "m" / "fundus" / "n" / "log.txt").read()
        assert f"at iteration {fail_it}; snapshot of iteration" in log
        snap = torch.load(dump / "state.pt", weights_only=True)
        batches = torch.load(dump / "batches.pt", weights_only=True)
        snap_it = snap["iter"]
        assert snap["world"] == 1
        assert 2 <= snap_it < fail_it <= snap_it + 2
        epochs = [b["epoch"] for b in batches["batches"]]
        assert epochs[0] != epochs[-1], "the dump should cross an epoch"

        capsys.readouterr()
        monkeypatch.delenv("UST_NAN_DEBUG")
        replayed = _recording(monkeypatch, nan_replay)
        assert nan_replay.main(["--dump", str(dump), "--health-every", "1",
                                "--", *argv]) == 1
        out = capsys.readouterr().out
        assert f"=== first non-finite at iter {fail_it}:" in out
        # the steps to the failure, then those before it again (the replay
        # returns to the state before the failing step)
        n = fail_it - snap_it
        assert len(replayed) == 2 * n - 1
        for got, want in zip(replayed[:n - 1] + replayed[n:],
                             2 * trained[snap_it:fail_it - 1]):
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, k)
        # the state before the failing step, restored from the snapshot a
        # second time: finite, as every loss before it was
        prefail = torch.load(dump / "prefail.pt", weights_only=True)
        assert prefail["iter"] == fail_it - 1
        for part in ("state_dict", "ema_state_dict"):
            assert all(torch.isfinite(t).all() for t in
                       prefail["state"][part].values()
                       if t.is_floating_point()), part
        named = [ln for ln in out.splitlines()
                 if ln.startswith("first non-finite module output: ")]
        assert named and named[0].split(": ")[1].startswith(
            ("student.", "teacher.")), out[-2000:]
        assert "detect_anomaly:" in out
    finally:
        shutil.rmtree(dump, ignore_errors=True)   # ~0.4 GB of state
