"""The benchmark of ust_run_tpu_torch: one run of one cell.

    python -m benchmarks.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Makes the weights, the corpus and the index rows from `--seed` on the
card, builds the port's train state, drives it through the cell's first
steps (kept for the comparison), warms up the cell's call, then runs
whole calls back to back for `--seconds`: the window ends at the fetch of
the last call's metrics, each call's metrics fetched one call behind, as
the trainer fetches them. Then it reads the peak memory, frees the
program's state and runs the plain reference over the first steps to
decide `correct` (benchmarks/check.py). With `--trace 1` the window is
followed by a profiled call of the cell and, for the operator split, a
few eager steps; the line then carries the per-layer metrics.

The last line of standard output is one JSON object: `correct`,
`attempted` (steps in the window), `failed` (steps whose loss is not
finite), `metrics`, `device`, with `--trace 1` `breakdown`, and last
`check`, each compared number beside its limit, which also close
standard error. Without CUDA, or with fewer cards than the cell asks for,
the run prints no result and exits with 2; with JAX or the JAX package
loaded it exits with 3.
"""

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

BLOCKED = ("jax", "jaxlib", "flax", "optax", "ust_run_tpu")
GIB = 2 ** 30


def process_start():
    """This process's start on the time.time() clock, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def blocked_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in BLOCKED
                   and sys.modules[m] is not None})


class Fetch:
    """A call's metrics copied to pinned host memory without blocking; the
    copy's event is what `get` waits on (on the CPU, the metrics)."""

    def __init__(self, metrics):
        import torch
        self.event = None
        if metrics.device.type != "cuda":
            self.host = metrics
            return
        self.host = torch.empty(metrics.shape, dtype=metrics.dtype,
                                pin_memory=True)
        self.host.copy_(metrics, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def window(started, seconds):
    """Whole calls back to back for `seconds`; returns (steps, seconds,
    losses of every step)."""
    from benchmarks.program import LOSS_COLUMN
    prog, cell = started.program, started.cell
    k = cell["steps_per_call"]
    pending, losses, steps = None, [], 0
    t0 = time.perf_counter()
    while True:
        fetch = Fetch(prog.call(started.data, started.stream.draw(k)))
        if pending is not None:
            losses.extend(pending.get()[:, LOSS_COLUMN].tolist())
        pending = fetch
        steps += k
        if time.perf_counter() - t0 >= seconds:
            break
    losses.extend(pending.get()[:, LOSS_COLUMN].tolist())
    return steps, time.perf_counter() - t0, losses


def traced(started, window_s, window_steps):
    """The per-layer context of a traced run: the cell's call profiled
    (`trace.calls` calls) and, for the operator split, `trace.eager_steps`
    eager steps (the call itself where it is eager)."""
    import torch
    from benchmarks import counting, trace
    cell, config = started.cell, started.config
    prog, t = started.program, cell["trace"]
    k = cell["steps_per_call"]

    def calls():
        for _ in range(t["calls"]):
            prog.call(started.data, started.stream.draw(k))

    eager = cell["call"] == "eager"
    win = trace.profile(calls, t["calls"] * k, ops=eager)
    ops = win if eager else trace.profile(
        lambda: prog.eager_steps(started.data,
                                 started.stream.draw(t["eager_steps"])),
        t["eager_steps"], ops=True)
    flops, conv_flops, conv_bytes = counting.step_counts(config, cell)
    return dict(config=config, cell=cell, window=win, ops=ops,
                timed_steps=window_steps, timed_s=window_s,
                flops_per_step=flops, conv_flops_per_step=conv_flops,
                conv_bytes_per_step=conv_bytes,
                uniform_rng_bytes=counting.uniform_rng_bytes(config, cell),
                peaks=counting.peaks(torch.cuda.get_device_name())
                if torch.cuda.is_available() else None)


def run_cell(bench, name, seed, seconds, trace, device, t_start,
             program_cls=None, cell=None, config=None):
    """Everything of a run after the look for a card: returns the result
    line (a dict) and the `check` lines. `program_cls`, `cell` and
    `config` stand in for the program and the cell's files (tests)."""
    import torch
    from benchmarks import check, harness, registry
    from benchmarks.program import Program
    entry = registry.entry(bench, name)
    cell = cell or registry.cell(name)
    config = config or registry.config(entry["config"])
    on_card = device.type == "cuda"

    started = harness.Started(config, cell, seed, device,
                              program_cls or Program)
    for _ in range(cell["warmup_calls"]):
        started.program.call(started.data,
                             started.stream.draw(cell["steps_per_call"]))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    steps, window_s, losses = window(started, seconds)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rate = steps * (cell["label_bs"] + cell["unlabel_bs"]) / window_s
    nonfinite = sum(not math.isfinite(v) for v in losses)
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": entry["chips"], "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        from benchmarks import trace as trace_mod
        ctx = traced(started, window_s, steps)
        metrics = {}
        for m in registry.metrics_of(bench, "per_layer", name):
            value = registry.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info.update(busy_s=ctx["window"].busy_s,
                    window_s=ctx["window"].wall_s)
        breakdown = trace_mod.breakdown(ctx["window"])
    else:
        e2e = {"train_img_per_s": rate, "peak_mem_gib": peak / GIB,
               "setup_s": setup_s}
        # a metric "<quantity>.<scope>" is the quantity in its own cells
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in registry.metrics_of(bench, "end_to_end", name)}

    started.free()
    ref = harness.reference(config, cell, seed, started.data, started.first)
    readings = check.compare(started.trajectory, ref)
    correct, numbers = check.verdict(readings, nonfinite, cell["limits"])
    notes = [f"[bench] {name} seed {seed}: {steps} steps in {window_s:.3f} "
             f"s, setup {setup_s:.3f} s, peak {peak / GIB:.3f} GiB; worst "
             f"leaves: grad {readings['grad_leaf']}, change "
             f"{readings['change_leaf']} ({readings['rounding_leaves']} "
             f"leaves at rounding left out)"]
    notes += [f"check {k} {v['value']!r} limit {v['limit']!r}"
              for k, v in numbers.items()]
    line = {"correct": correct, "attempted": steps, "failed": nonfinite,
            "metrics": metrics, "device": info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = numbers
    return line, notes


def main(argv=None):
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmarks import registry
    bench = registry.benchmark()
    chips = registry.entry(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    line, notes = run_cell(bench, args.workload, args.seed, args.seconds,
                           args.trace, torch.device("cuda", 0), t_start)
    found = blocked_modules()
    if found:
        print(f"[bench] modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    print("\n".join(notes), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
