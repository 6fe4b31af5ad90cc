"""Package-level checks of ust_run_tpu_torch: it imports no JAX, it has no
silent CPU fallback, its CLI mirrors the JAX package's, its trainer runs
end to end on the CPU when asked to, and (on a card only) its CUDA kernel
is bit-equal to the plain version."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports with jax, flax,
    optax and ust_run_tpu blocked."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "ust_run_tpu"):
    sys.modules[name] = None          # any import of these now fails
import ust_run_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ust_run_tpu_torch.__path__,
                                               "ust_run_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "optax", "ust_run_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_no_cpu_fallback(tmp_path, monkeypatch):
    """Without CUDA, every entry raises unless the CPU is asked for."""
    from ust_run_tpu_torch import train
    from ust_run_tpu_torch.ops import rng
    from ust_run_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        rng.uniform_batch(2, 8, generator=g, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--dataset", "fundus", "--model_root", str(tmp_path),
                    "--data_root", str(tmp_path)])
    assert not os.listdir(tmp_path)          # raised before touching files
    assert rng.uniform_batch(2, 8, generator=g, device="cpu").shape \
        == (2, 8, 8)


def test_cli_and_hyperparams_mirror_jax():
    from ust_run_tpu.config import build_parser as jax_parser
    from ust_run_tpu.semisup.step import HyperParams as JaxHP
    from ust_run_tpu_torch.config import build_parser
    from ust_run_tpu_torch.semisup.step import HyperParams

    ours = {a.dest: a.default for a in build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    assert [f.name for f in dataclasses.fields(HyperParams)] == \
        [f.name for f in dataclasses.fields(JaxHP)]


def test_trainer_entry_runs_on_cpu_when_asked(tmp_path):
    """The module entry end to end at a tiny size with --device cpu: a
    synthetic fundus corpus, two epochs of two steps, finite losses in
    the log, the RNG's plain version on the CPU."""
    from ust_run_tpu_torch import train
    from ust_run_tpu_torch.data.synthetic import generate
    from ust_run_tpu_torch.ops import rng

    root = generate("fundus", str(tmp_path / "fundus"), n_train=5,
                    n_test=1, size=32, seed=0)
    before = rng.launches
    trainer = train.main([
        "--dataset", "fundus", "--data_root", root, "--lb_domain", "1",
        "--lb_num", "3", "--save_name", "t", "--max_iterations", "4",
        "--num_eval_iter", "2", "--log_interval", "1", "--patch_override",
        "32", "--model_root", str(tmp_path / "model"), "--device", "cpu"])
    assert trainer.iter_num == 4 and trainer.state.step == 4
    assert rng.launches == before             # no kernel on the CPU
    log = open(tmp_path / "model" / "fundus" / "t" / "log.txt").read()
    lines = [ln for ln in log.splitlines() if "iteration" in ln
             and "sup_loss" in ln]
    assert len(lines) == 2, log
    for ln in lines:
        loss = float(ln.split("loss : ")[1].split(",")[0])
        assert np.isfinite(loss)
    assert "epoch 2:" in log


@pytest.mark.cuda
def test_uniform_kernel_bit_equal_on_card():
    """On a card: the CUDA kernel equals its plain version bit for bit at
    the main path's shape and a ragged one, and counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from ust_run_tpu_torch.ops import rng

    for n, size in ((16, 256), (3, 37)):
        out = torch.empty((n, size, size), device="cuda")
        before = rng.launches
        rng.uniform_fields(out, 12345)
        assert rng.launches == before + 1
        plain = rng.uniform_batch_plain(n, size, 12345, device="cuda")
        assert torch.equal(out, plain)
