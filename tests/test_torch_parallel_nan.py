"""UST_NAN_DEBUG on two Gloo ranks (CPU, patch 32): the losses are
replicated, so every rank sees the first non-finite loss at the same
iteration and exits with code 3, rank 0 alone writing the dump
(trainer.py:372-389). `--base_lr 1e4` diverges within a few steps. At
2 steps per call (`--unroll_steps 2`, eager steps on a mesh) the snapshot
before the failing call is a rolling one (iteration 2 or later), as at
one step per call; at the default 10 it is the one before the first
call."""

import shutil

import pytest
import torch

import torch_dist as td
from torch_threads import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")


def test_nan_dump_on_two_ranks(tmp_path):
    argv = td.entry_argv(tmp_path)
    dump = tmp_path / "nan"
    res = td.run_ranks(tmp_path, 2, td.run_train_entry,
                       argv + ["--save_name", "nan", "--base_lr", "1e4",
                               "--num_eval_iter", "20", "--unroll_steps",
                               "2"],
                       {"UST_NAN_DEBUG": str(dump), "UST_NAN_SNAP": "2"})
    assert res == [{"step": None, "exit": 3}] * 2
    log = open(tmp_path / "model" / "fundus" / "nan" / "log.txt").read()
    assert log.count("non-finite loss") == 1
    snap = torch.load(dump / "state.pt", weights_only=True)
    assert snap["iter"] >= 2 and snap["state"]["step"] == snap["iter"]
    assert snap["world"] == 2
    shutil.rmtree(dump)                       # ~0.4 GB of state


def test_nan_dump_on_two_ranks_default_unroll(tmp_path):
    """The same run at the default `--unroll_steps 10`: snapshots fall
    between calls, so the dump holds the snapshot of iteration 0 and the
    one call of 10 batches after it that went non-finite."""
    argv = td.entry_argv(tmp_path)
    dump = tmp_path / "nan"
    res = td.run_ranks(tmp_path, 2, td.run_train_entry,
                       argv + ["--save_name", "nan", "--base_lr", "1e4",
                               "--num_eval_iter", "20"],
                       {"UST_NAN_DEBUG": str(dump), "UST_NAN_SNAP": "2"})
    assert res == [{"step": None, "exit": 3}] * 2
    log = open(tmp_path / "model" / "fundus" / "nan" / "log.txt").read()
    assert log.count("non-finite loss") == 1
    snap = torch.load(dump / "state.pt", weights_only=True)
    assert snap["iter"] == 0 and snap["state"]["step"] == 0
    assert snap["world"] == 2
    batches = torch.load(dump / "batches.pt", weights_only=True)
    assert batches["unroll"] == 10
    assert [tuple(b["lb_idx"].shape)[0] for b in batches["batches"]] == [10]
    shutil.rmtree(dump)                       # ~0.4 GB of state
