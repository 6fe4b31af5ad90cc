"""Tests of the benchmark: `python -m pytest benchmarks/tests` from the
repository's root. Tests marked `cuda` need a card and skip without one;
on the card: `python -m pytest benchmarks/tests -m cuda`."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny(name, patch=32, eager=False):
    """Cell `name`'s files at a size the CPU runs in seconds: patch 32,
    batch 2+2, 16 corpus images, at most 2 steps a call; with `eager`,
    one eager `step_fn` a call instead of the K-step call."""
    from benchmarks import registry
    cell = registry.cell(name)
    config = registry.config(cell["config"])
    config["patch"] = patch
    cell.update(corpus_images=16, label_bs=2, unlabel_bs=2, warmup_calls=1,
                steps_per_call=min(cell["steps_per_call"], 2))
    if eager:
        cell.update(call="eager", steps_per_call=1,
                    trace={"calls": 2, "eager_steps": 2})
    return cell, config
