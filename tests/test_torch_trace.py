"""The step's spans and stage clock (ust_run_tpu_torch/utils/trace.py): on
the CPU through the plain clock, and on the card through the stamp kernel
of csrc/stage_clock.cu inside the captured step.

On the CPU: nested spans give self times, the time between spans goes to
no span, each clocked span of `step_fn` and of the CPU `multi_step` (K
eager bodies) counts once a step and the stages add up to the steps'
host time, the host spans nest in a torch.profiler session and enter no
host range without one, `reset` zeroes the clock, the stamps
change no result, and the trainer logs the epoch's stage line. On the
card (`cuda`): the graph path counts each replay, the stages of a call
add up to its CUDA-event time, and a capture with stamps gives the same
bits in two runs of one seed and without stamps.
"""

import contextlib
import time

import pytest
import torch

from torch_threads import single_thread  # noqa: F401
from torch_unroll import (assert_states_equal, corpus, hp_for, index_rows,
                          new_state)
from ust_run_tpu_torch.semisup import step as pstep
from ust_run_tpu_torch.utils import trace

pytestmark = pytest.mark.usefixtures("single_thread")

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean_clock():
    trace.reset()
    yield
    trace.reset()
    assert not trace._open


def fake_clock(monkeypatch, times):
    """The plain clock reads `times` (ns), one a stamp."""
    it = iter(times)
    monkeypatch.setattr(trace, "cpu_clock", lambda: next(it))


def totals():
    return trace.stage_totals(CPU, "eager")


def test_nested_spans_give_self_times(monkeypatch):
    """step.inputs holds step.teacher_fwd: the outer span keeps only the
    time outside the inner one."""
    fake_clock(monkeypatch, [1000, 1010, 1040, 1045])
    with trace.span("step.inputs", CPU):
        with trace.span("step.teacher_fwd", CPU):
            pass
    got = totals()
    assert got["step.inputs"] == (1, 15e-9)
    assert got["step.teacher_fwd"] == (1, 30e-9)
    assert all(got[s] == (0, 0.0) for s in trace.STAGES[2:])


def test_time_between_spans_goes_to_none(monkeypatch):
    """Two spans one after the other: the gap between them, where no span
    is open, is added to neither."""
    fake_clock(monkeypatch, [0, 100, 5000, 5300, 9000, 9004])
    for name in ("step.backward", "step.update", "step.backward"):
        with trace.span(name, CPU):
            pass
    got = totals()
    assert got["step.backward"] == (2, 104e-9)
    assert got["step.update"] == (1, 300e-9)


def test_host_only_span_leaves_the_clock(monkeypatch):
    """A span without a device takes no stamp, even around a clocked
    one."""
    fake_clock(monkeypatch, [10, 30])
    with trace.span("call.feeds"):
        with trace.span("step.update", CPU):
            pass
    assert totals()["step.update"] == (1, 20e-9)


def test_error_in_span_leaves_no_stamp(monkeypatch):
    """A span left by an exception takes no stamp at its exit and is no
    longer open."""
    fake_clock(monkeypatch, [0])
    with pytest.raises(ValueError):
        with trace.span("step.backward", CPU):
            raise ValueError("boom")
    assert not trace._open
    assert totals()["step.backward"] == (0, 0.0)


def test_stage_totals_paths():
    """Every stage is reported; the CPU has no graph path; a path is
    `graph` or `eager`."""
    assert list(totals()) == list(trace.STAGES)
    with trace.span("step.inputs", CPU):
        pass
    assert trace.stage_totals(CPU, "graph")["step.inputs"] == (0, 0.0)
    assert totals()["step.inputs"][0] == 1
    with pytest.raises(ValueError, match="path"):
        trace.stage_totals(CPU, "replay")


def test_reset_zeroes_the_clock():
    with trace.span("step.inputs", CPU):
        with trace.span("step.teacher_fwd", CPU):
            time.sleep(0.001)
    assert totals()["step.teacher_fwd"][0] == 1
    pstep.reset_counts()
    assert all(v == (0, 0.0) for v in totals().values())


def _setup(k):
    hp = hp_for("fundus")
    return hp, corpus(hp, 0), new_state(hp, 0), index_rows(1, k, hp)


def _steps(kind, st, data, rows, hp):
    if kind == "step_fn":
        for r in rows:
            pstep.step_fn(st, data, r, hp)
        return
    idxs = {n: torch.stack([r[n] for r in rows]) for n in rows[0]}
    feeds = pstep.host_to_device(pstep.draw_feeds(st, hp, len(rows)), "cpu")
    pstep.multi_step(st, data, idxs, feeds, hp)


@pytest.mark.parametrize("kind", ["step_fn", "multi_step"])
def test_steps_count_each_stage(kind):
    """Each clocked span counts once a step, and the stages add up to the
    steps' host time within 20% (what lies outside them: the feed's draw
    and copy, zeroing the gradients)."""
    k = 3
    hp, data, st, rows = _setup(k)
    t0 = time.perf_counter()
    _steps(kind, st, data, rows, hp)
    wall = time.perf_counter() - t0
    got = totals()
    assert {s: n for s, (n, _) in got.items()} == dict.fromkeys(
        trace.STAGES, k)
    assert all(sec > 0 for _, sec in got.values())
    total = sum(sec for _, sec in got.values())
    assert 0.8 * wall <= total <= wall, (total, wall)


def test_host_spans_nest_in_profiler():
    """In a CPU torch.profiler session of step_fn each span is a host
    range, step.teacher_fwd inside step.inputs and the step's parts after
    the feed's draw and copy."""
    hp, data, st, rows = _setup(1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pstep.step_fn(st, data, rows[0], hp)
    ranges = {}
    for e in prof.events():
        if e.name.startswith(("step.", "call.")):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    assert set(ranges) == set(trace.STAGES) | {"call.feeds",
                                               "call.to_device"}
    assert all(len(v) == 1 for v in ranges.values()), ranges
    (outer,), (inner,) = ranges["step.inputs"], ranges["step.teacher_fwd"]
    assert outer[0] <= inner[0] <= inner[1] <= outer[1]
    order = [ranges[s][0] for s in ("call.feeds", "step.inputs",
                                    "step.student_fwd", "step.backward",
                                    "step.update")]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:])), order
    assert totals()["step.update"][0] == 1


@pytest.mark.parametrize("profiling", [False, True])
def test_host_range_only_under_profiler(monkeypatch, profiling):
    """Without a profiler session no span enters a host range (a record
    function); under one, each span enters one."""
    entered = []

    def spy(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(trace, "_host_range", spy)
    monkeypatch.setattr(trace, "_profiling", lambda: profiling)
    hp, data, st, rows = _setup(1)
    pstep.step_fn(st, data, rows[0], hp)
    assert sorted(entered) == (sorted(
        ["call.feeds", "call.to_device", *trace.STAGES]) if profiling
        else [])
    assert totals()["step.inputs"][0] == 1


def test_stamps_change_no_result(monkeypatch):
    """Two steps with the clock and two with every span a no-op, from one
    seed: every state tensor equal."""
    def run():
        hp, data, st, rows = _setup(2)
        _steps("step_fn", st, data, rows, hp)
        return st

    clocked = run()
    monkeypatch.setattr(pstep, "span",
                        lambda *a, **k: contextlib.nullcontext())
    assert_states_equal(clocked, run())


def test_trainer_logs_the_stage_line(tmp_path):
    """A short CPU run logs, after the epoch's images/s line, its device
    ms a step in each clocked span on the eager path."""
    from ust_run_tpu_torch import train
    from ust_run_tpu_torch.data.synthetic import generate

    root = generate("fundus", str(tmp_path / "fundus"), n_train=5,
                    n_test=1, size=32, seed=0)
    train.main(["--dataset", "fundus", "--data_root", root, "--lb_domain",
                "1", "--lb_num", "3", "--num_eval_iter", "2",
                "--max_iterations", "2", "--patch_override", "32",
                "--eval_batch", "2", "--model", "unet2d", "--model_root",
                str(tmp_path / "model"), "--save_name", "t", "--device",
                "cpu"])
    log = open(tmp_path / "model" / "fundus" / "t" / "log.txt").read()
    lines = log.splitlines()
    at = next(i for i, ln in enumerate(lines) if "epoch 1:" in ln)
    line = lines[at + 1]
    assert "epoch 1 stages, device ms a step: eager x2: " in line, line
    values = line.split("eager x2: ")[1].split(", ")
    assert [v.split()[0] for v in values] == [
        s.split(".")[1] for s in trace.STAGES]
    assert all(float(v.split()[1]) > 0 for v in values)


# ------------------------------------------------------------------ card

def _bench(unroll=10):
    from ust_run_tpu_torch import bench
    cfg, _ = bench.bench_config({})
    cfg.unroll_steps = unroll
    return bench.Bench(cfg, "cuda")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the stamp kernel has no CPU mode)")


@pytest.mark.cuda
def test_graph_counts_equal_replays_on_card():
    """On a card, the fundus UNet at 10 steps a call: after a capturing
    call, K replays count K on the graph path in each clocked span and
    nothing on the eager path; the capturing call's first step, run
    eagerly, counted once on the eager path."""
    _card()
    b = _bench()
    pstep.reset_counts()
    b.calls(1)
    eager = trace.stage_totals("cuda", "eager")
    assert {s: n for s, (n, _) in eager.items()} == dict.fromkeys(
        trace.STAGES, 1)
    pstep.reset_counts()
    b.calls(3)
    replays = pstep.graph_counts["replays"]
    assert replays == 30
    graph = trace.stage_totals("cuda", "graph")
    assert {s: n for s, (n, _) in graph.items()} == dict.fromkeys(
        trace.STAGES, replays)
    assert all(sec > 0 for _, sec in graph.values())
    assert all(n == 0 for n, _ in trace.stage_totals("cuda",
                                                     "eager").values())


@pytest.mark.cuda
def test_stage_sum_matches_call_time_on_card():
    """On a card: the stages of one call of 10 replays add up to the
    call's CUDA-event time within 5% (outside them: the index and feed
    copies, the metric rows, the stamps themselves). A spin keeps the
    card busy while the host draws and queues the call, as in
    `chip_smoke.stage_clock_spins`: else the events would also time the
    card's wait for the host's draws, which no stage holds."""
    _card()
    b = _bench()
    b.calls(2)
    torch.cuda.synchronize()
    pstep.reset_counts()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda._sleep(400_000_000)          # cycles: ~0.2 s at the boost clock
    start.record()
    b.calls(1)
    end.record()
    torch.cuda.synchronize()
    call_s = start.elapsed_time(end) / 1e3
    got = trace.stage_totals("cuda", "graph")
    total = sum(sec for _, sec in got.values())
    assert abs(total - call_s) <= 0.05 * call_s, (total, call_s, got)


@pytest.mark.cuda
def test_capture_with_stamps_is_deterministic_on_card(monkeypatch):
    """On a card under --deterministic 1: two runs of one seed, each
    capturing the step with its stamps and replaying it, end in the same
    bits, and so does a run with every span a no-op."""
    _card()
    from torch_unroll import state_tensors

    def run():
        b = _bench()
        b.calls(2)
        torch.cuda.synchronize()
        out = {k: v.cpu() for k, v in state_tensors(b.state).items()}
        b.state.graph = None
        del b
        torch.cuda.empty_cache()
        return out

    first, second = run(), run()
    monkeypatch.setattr(pstep, "span",
                        lambda *a, **k: contextlib.nullcontext())
    plain = run()
    for other in (second, plain):
        assert other.keys() == first.keys()
        assert [k for k in first
                if not torch.equal(first[k], other[k])] == []
