"""The plain reference against the port's step at a tiny size on the
CPU, both in float32: the same weights, corpus and rows give the same
losses, gradients of every step and state.

The UNet agrees to 1e-3. DeepLabV2-R101 at random init is ill-conditioned
in float32: at this size the reference and the port each read some
BatchNorm weight's gradient norm about 1% away from the same reference
in float64 (logits 2-3e-4 away), so its gradient and state are held at
5e-2."""

import pytest
import torch

from benchmarks import check, harness
from conftest import tiny


@pytest.mark.parametrize("name,eager,steps,tol", [
    ("unet_fundus.graph", False, 3, 1e-3),
    ("unet_fundus.graph", True, 3, 1e-3),
    ("deeplabv2_r101_fundus.graph", False, 1, 5e-2)])
def test_reference_agrees_with_step_fn(name, eager, steps, tol):
    cell, config = tiny(name, eager=eager)
    cell["checked_steps"] = steps
    started = harness.Started(config, cell, 2 ** 31 + 3, torch.device("cpu"))
    started.free()
    ref = harness.reference(config, cell, 2 ** 31 + 3, started.data,
                            started.first)
    r = check.compare(started.trajectory, ref)
    assert r["loss_gap"] < 1e-5, r
    assert r["grad_gap"] < tol, r
    assert r["grad_gap_step2"] < tol, r
    assert r["change_gap"] < tol, r
