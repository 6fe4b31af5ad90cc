"""UST_NAN_DEBUG on two Gloo ranks (CPU, patch 32): the losses are
replicated, so every rank sees the first non-finite loss at the same
iteration and exits with code 3, rank 0 alone writing the dump
(trainer.py:372-389). `--base_lr 1e4` diverges within a few steps."""

import shutil

import torch

import torch_dist as td


def test_nan_dump_on_two_ranks(tmp_path):
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
    assert snap["iter"] >= 2 and snap["state"]["step"] == snap["iter"]
    assert snap["world"] == 2
    shutil.rmtree(dump)                       # ~0.4 GB of state
