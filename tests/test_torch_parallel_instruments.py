"""UST_STOP_AFTER_ITERS on two Gloo ranks (CPU, patch 32): the iteration
count is replicated, so every rank stops at the same iteration
(trainer.py:315-323) and rank 0 alone logs the line."""

import torch_dist as td


def test_stop_after_on_two_ranks(tmp_path):
    argv = td.entry_argv(tmp_path)
    res = td.run_ranks(tmp_path, 2, td.run_train_entry,
                       argv + ["--save_name", "stop"],
                       {"UST_STOP_AFTER_ITERS": "2"})
    assert res == [{"step": 2, "exit": None}] * 2
    log = open(tmp_path / "model" / "fundus" / "stop" / "log.txt").read()
    assert log.count("UST_STOP_AFTER_ITERS=2 reached at iter 2") == 1
