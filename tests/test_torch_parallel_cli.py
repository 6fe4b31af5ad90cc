"""The data-parallel launch of the port's train entry on the CPU:
`torchrun --nproc_per_node 2 -m ust_run_tpu_torch.train ... --device cpu`
(Gloo) against the same flags in one process. Bar: the first step's
logged losses to rtol 1e-5 (test_torch_parallel_step.py holds the whole
step at the same bar)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist as td
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu_torch import train
from ust_run_tpu_torch.data import synthetic

pytestmark = pytest.mark.usefixtures("single_thread")


def _iteration_losses(log):
    """{iteration: (loss, sup_loss)} from a trainer log."""
    out = {}
    for ln in log.splitlines():
        if "iteration" in ln and "sup_loss" in ln:
            it = int(ln.split("iteration ")[1].split()[0])
            out[it] = (float(ln.split("loss : ")[1].split(",")[0]),
                       float(ln.split("sup_loss : ")[1].split(",")[0]))
    return out


def test_torchrun_launch_matches_one_process(tmp_path):
    """`torchrun --nproc_per_node 2 -m ust_run_tpu_torch.train ...` with
    --device cpu (Gloo): two epochs of one step, each with its evaluation
    and checkpoint. Rank 0 alone logs and writes; the first step's losses
    are one process's; --num_devices 2 is accepted."""
    root = synthetic.generate("fundus", str(tmp_path / "fundus"), n_train=5,
                              n_test=1, size=32, seed=0)
    common = ["--dataset", "fundus", "--data_root", root, "--lb_domain", "1",
              "--lb_num", "3", "--num_eval_iter", "1", "--max_iterations",
              "2", "--patch_override", "32", "--eval_batch", "2",
              "--model_root", str(tmp_path / "model"), "--device", "cpu"]
    with td.one_thread():
        one = train.main(common + ["--save_name", "one"])
    assert one.state.step == 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ust_run_tpu_torch.train", *common,
         "--save_name", "two", "--num_devices", "2"],
        cwd=repo, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    snap = tmp_path / "model" / "fundus"
    log1 = open(snap / "one" / "log.txt").read()
    log2 = open(snap / "two" / "log.txt").read()
    assert log2.count("test ema model") == 2          # rank 0 alone logs
    assert log2.count("save checkpoint to") == 2
    assert sorted(os.listdir(snap / "two")) == sorted(os.listdir(snap / "one"))
    ckpt = torch.load(snap / "two" / "checkpoint.pth", weights_only=False)
    assert ckpt["epoch"] == 2
    l1, l2 = _iteration_losses(log1), _iteration_losses(log2)
    assert sorted(l2) == [1, 2]
    np.testing.assert_allclose(l2[1], l1[1], rtol=1e-5)
    assert np.isfinite(l2[2]).all()
