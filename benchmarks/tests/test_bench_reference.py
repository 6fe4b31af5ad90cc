"""The plain reference against the port's step at a tiny size on the
CPU, both in float32: the same weights, corpus and rows give the same
losses, gradients of every step and state.

The fundus UNet agrees to 1e-3. The prostate UNet's softmax path takes
the argmax of two logits, which random weights leave within 1e-4 of each
other at a few pixels of a batch (1 to 3 of 2,048 a group at seed 11),
so the two sides' float32 rounding can flip a pseudo-label and move a
gradient norm by up to ~1e-2 (4.2e-3 at this seed, 9.4e-3 the most over
five seeds at two threads; 1e-6 at four threads, where none flips): it
is held at 1e-2. DeepLabV2-R101 at random init is ill-conditioned in
float32: at this size the reference and the port each read some
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
    ("unet_prostate.graph", False, 3, 1e-2),
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
