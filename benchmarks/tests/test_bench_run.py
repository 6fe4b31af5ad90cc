"""A whole run on the CPU at a tiny size, past the look for a card: the
result line's keys, the comparison passing on the program as it is and
failing with the timed path broken underneath."""

import time

import pytest
import torch

from benchmarks import readings, registry, run
from benchmarks.program import Program
from conftest import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def _run(name, trace=0, program_cls=None, limits=None, eager=False):
    cell, config = tiny(name, eager=eager)
    if limits is not None:
        cell["limits"] = limits
    return run.run_cell(registry.benchmark(), name, 7, 0.5, trace,
                        torch.device("cpu"), time.time(),
                        program_cls=program_cls, cell=cell, config=config)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("eager", [False, True])
def test_line_keys(trace, eager):
    line, notes = _run("unet_fundus.graph", trace, eager=eager)
    keys = KEYS[:5] + (["breakdown"] if trace else []) + ["check"]
    assert list(line) == keys
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line["check"]) == list(registry.cell(
        "unet_fundus.graph")["limits"]) + ["nonfinite_steps"]
    assert notes[-1].startswith("check nonfinite_steps")
    if not trace:
        assert set(line["metrics"]) == {"train_img_per_s", "peak_mem_gib",
                                        "setup_s"}
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_program_passes():
    """The port as it is agrees with the reference far inside the cell's
    limits (float32 on the CPU)."""
    line, _ = _run("unet_fundus.graph")
    assert line["correct"], line["check"]
    for name, v in line["check"].items():
        assert v["value"] < 1e-3, name


class Unchanged(Program):
    """A step that returns its state unchanged: each call's writes to the
    state are undone."""

    def call(self, data, idx):
        keep = {k: v.clone() for k, v in self.leaves().items()}
        mom = {k: v.clone() for k, v in self.momentum_or_empty().items()}
        out = super().call(data, idx)
        for k, v in self.leaves().items():
            v.copy_(keep[k])
        for k, v in self.momentum_or_empty().items():
            v.copy_(mom[k]) if k in mom else v.zero_()
        return out

    def momentum_or_empty(self):
        st = self.state.optimizer.state
        return {n: st[p]["momentum_buffer"]
                for n, p in self.state.student.named_parameters()
                if p in st and st[p].get("momentum_buffer") is not None}


UNETS = ["unet_fundus.graph", "unet_prostate.graph"]


@pytest.mark.parametrize("name", UNETS)
def test_unchanged_state_fails(name):
    """An unchanged state reads 1 on every change number the cell
    compares, and fails it."""
    line, _ = _run(name, program_cls=Unchanged)
    assert not line["correct"]
    change = {k: v for k, v in line["check"].items()
              if k.startswith("change_gap")}
    assert change and all(v["value"] == pytest.approx(1.0)
                          and v["value"] > v["limit"]
                          for v in change.values()), change


@pytest.mark.parametrize("name", UNETS)
def test_half_batch_fails(monkeypatch, name):
    """Half of each group's rows left out of every loss term, the mean
    taken over the rest."""
    from ust_run_tpu_torch.semisup import step as step_mod
    plain = step_mod.L.ce_plus_dice

    def half(logits, target, mask=None, **kw):
        n = logits.shape[0] // 2
        kw["rows"] = n
        return plain(logits[:n], target[:n],
                     mask=None if mask is None else mask[:n], **kw)

    monkeypatch.setattr(step_mod.L, "ce_plus_dice", half)
    line, _ = _run(name)
    assert not line["correct"]
    assert any(v["value"] > v["limit"] for v in line["check"].values())


class ReplayHalfBatch(Program):
    """Half of each group's rows left out of every loss term from the
    cell's second call on: on the card, in the replays of the captured
    step alone (the first call runs the step eagerly, then captures it)."""

    def call(self, data, idx):
        self.calls = getattr(self, "calls", 0) + 1
        if self.calls == 1:
            return super().call(data, idx)
        from ust_run_tpu_torch.semisup import step as step_mod
        plain = step_mod.L.ce_plus_dice

        def half(logits, target, mask=None, **kw):
            n = logits.shape[0] // 2
            kw["rows"] = n
            return plain(logits[:n], target[:n],
                         mask=None if mask is None else mask[:n], **kw)

        step_mod.L.ce_plus_dice = half
        try:
            return super().call(data, idx)
        finally:
            step_mod.L.ce_plus_dice = plain


@pytest.mark.parametrize("name", ["unet_fundus.graph",
                                  "deeplabv2_r101_fundus.graph",
                                  "unet_prostate.graph"])
def test_replay_half_batch_fails(name):
    """A fault confined to the steps after the first fails the second
    step's numbers, while the first step's read as sound."""
    line, _ = _run(name, program_cls=ReplayHalfBatch)
    assert not line["correct"]
    check = line["check"]
    assert all(check[k]["value"] <= check[k]["limit"]
               for k in ("grad_gap", "loss_gap_first") if k in check), check
    assert any(check[k]["value"] > check[k]["limit"]
               for k in ("grad_gap_step2", "grad_gap_step2_median",
                         "change_gap_params") if k in check), check


@pytest.mark.parametrize("name", UNETS)
def test_control_fails(name):
    """The reference in float8 (the control of the bf16 UNet) fails a
    limit of the cell, and so does half the batch; the program in float32
    passes."""
    cell, config = tiny(name)
    r = readings.read_seed(config, cell, 11, torch.device("cpu"))
    limits = cell["limits"]
    assert any(r["control"][k] > v for k, v in limits.items()), r
    assert any(r["half_batch"][k] > v for k, v in limits.items()), r
    assert all(r["program"][k] < v for k, v in limits.items()), r
