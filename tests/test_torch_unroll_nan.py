"""UST_NAN_DEBUG and the replay at `--unroll_steps 2` against 1, on the
CPU at patch 32 (the setup of tests/test_torch_nan_replay.py with
`--model unet2d`, whose narrower widths keep the file cheap, and epochs
of 8 iterations, which 2 divides, so the run fails inside its first
epoch, before any evaluation or checkpoint): a `--base_lr 30000` run
goes non-finite at the same iteration in both (4, the second step of its
call), writes the same log lines, dumps the same steps' batches (at unroll 2 one entry per call of two, with the run's
`unroll`), and `python -m ust_run_tpu_torch.nan_replay` of the unroll-2
dump replays them as eager steps, reproduces the unroll-1 run's metric
rows bit for bit, names the failing iteration and its place in its
call, and exits 1."""

import logging
import re

import numpy as np
import pytest
import torch

from torch_unroll import single_thread  # noqa: F401
from ust_run_tpu_torch import nan_replay, train
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.engine import trainer as trainer_mod

pytestmark = pytest.mark.usefixtures("single_thread")

_STAMP = re.compile(r"^\[[^\]]*\]\s*")


def _argv(root, model_root, unroll):
    return ["--dataset", "fundus", "--data_root", root, "--lb_num", "3",
            "--patch_override", "32", "--eval_batch", "2", "--domain_num",
            "1", "--num_eval_iter", "8", "--base_lr", "30000", "--model_root",
            model_root, "--save_name", "n", "--overwrite", "--device", "cpu",
            "--unroll_steps", str(unroll), "--model", "unet2d"]


def _run(monkeypatch, argv, dump):
    """The train entry with UST_NAN_DEBUG=dump: (exit code, the metric
    rows the trainer drained, its log lines without timestamps, timing
    and the flags' echo)."""
    rows, unpack = [], trainer_mod.unpack_metrics
    monkeypatch.setattr(trainer_mod, "unpack_metrics",
                        lambda v, hp: rows.append(unpack(v, hp)) or rows[-1])
    monkeypatch.setenv("UST_NAN_DEBUG", dump)
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        with pytest.raises(SystemExit) as exit_:
            train.main(argv)
    finally:
        for h in root.handlers[len(before):]:
            root.removeHandler(h)
            h.close()
        monkeypatch.setattr(trainer_mod, "unpack_metrics", unpack)
    model_root = argv[argv.index("--model_root") + 1]
    text = open(f"{model_root}/fundus/n/log.txt").read()
    lines = [_STAMP.sub("", ln).replace(model_root, "ROOT")
             for ln in text.splitlines()]
    return exit_.value.code, rows, [
        ln for ln in lines if ln.strip() and " it/s, " not in ln
        and not ln.startswith(("Namespace(", "python "))]


def test_nan_dump_and_replay_at_unroll_two(tmp_path, monkeypatch, capsys):
    root = generate("fundus", str(tmp_path / "data"), n_train=5, n_test=1,
                    size=32, seed=0)
    monkeypatch.setenv("UST_NAN_SNAP", "2")
    runs = {u: _run(monkeypatch, _argv(root, str(tmp_path / f"m{u}"), u),
                    str(tmp_path / "nan")) for u in (1, 2)}
    (code1, rows1, log1), (code2, rows2, log2) = runs[1], runs[2]
    assert code1 == code2 == 3
    assert log2 == log1
    fail_it = len(rows1)
    assert len(rows2) == fail_it and not np.isfinite(float(rows2[-1]["loss"]))
    assert any(f"at iteration {fail_it}; snapshot of iteration" in ln
               for ln in log2)
    dumped = torch.load(tmp_path / "nan" / "batches.pt", weights_only=True)
    assert dumped["unroll"] == 2
    assert all(b["lb_idx"].shape[0] == 2 for b in dumped["batches"])
    snap_it = torch.load(tmp_path / "nan" / "state.pt",
                         weights_only=True)["iter"]

    capsys.readouterr()
    monkeypatch.delenv("UST_NAN_DEBUG")
    replayed, unpack = [], nan_replay.unpack_metrics
    monkeypatch.setattr(nan_replay, "unpack_metrics",
                        lambda v, hp: replayed.append(unpack(v, hp))
                        or replayed[-1])
    argv = _argv(root, str(tmp_path / "m2"), 2)
    assert nan_replay.main(["--dump", str(tmp_path / "nan"), "--"]
                           + [a for a in argv if a != "--overwrite"]) == 1
    out = capsys.readouterr().out
    assert f"=== first non-finite at iter {fail_it}:" in out
    place = (fail_it - snap_it - 1) % 2 + 1
    assert f"step {place} of call " in out and "(unroll 2)" in out
    n = fail_it - snap_it
    for got, want in zip(replayed[:n], rows1[snap_it:fail_it]):
        for k, v in want.items():
            if k not in ("loss", "sup_loss", "unsup_loss_ul", "unsup_loss_lu",
                         "unsup_loss_s") or np.isfinite(v).all():
                np.testing.assert_array_equal(got[k], v, k)
    assert any(ln.startswith("first non-finite module output: student.")
               or ln.startswith("first non-finite module output: teacher.")
               for ln in out.splitlines()), out[-2000:]
