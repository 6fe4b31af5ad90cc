"""The readings a cell's limits are set from (benchmarks/check.py).

    python -m benchmarks.readings --workload <cell> --seeds <n> [<n> ...]
                                  [--faults NAME ...] [--out FILE]

For each seed, in one process: the program through the cell's checked
steps as a run takes them (no window), then the plain reference in
float32, the control (the reference in the configuration's
`control_precision`: TF32 for float32, float8 for bfloat16) and the
reference with each of its faults (`benchmarks/reference/step.py`): half
of each group's rows left out of the loss at every step, the same from
the second step on, and the first step's rows taken again at the later
steps. Prints one JSON line a seed with the numbers of the program, of
the control and of each fault, each against the float32 reference. A
step that leaves the state unchanged reads 1 on `change_gap` by
construction. No number catches the stale rows: every number compares
norms, and a gradient of other rows of the same corpus has the norm of
the right one; they are read to show it.
"""

FAULTS = ("half_batch", "half_batch_replay", "stale_rows")

import argparse
import json
import sys
import time


def read_seed(config, cell, seed, device, faults=FAULTS):
    from benchmarks import check, harness
    t0 = time.perf_counter()
    started = harness.Started(config, cell, seed, device)
    started.free()
    t1 = time.perf_counter()
    ref = harness.reference(config, cell, seed, started.data, started.first)
    t2 = time.perf_counter()
    sides = {"program": started.trajectory,
             "control": harness.reference(config, cell, seed, started.data,
                                          started.first,
                                          config["control_precision"])}
    sides.update({fault: harness.reference(config, cell, seed, started.data,
                                           started.first, fault=fault)
                  for fault in faults})
    out = {"seed": seed, "program_s": t1 - t0, "reference_s": t2 - t1,
           "loss": {"program": started.losses, "reference": ref["loss"]}}
    out.update({k: check.compare(v, ref) for k, v in sides.items()})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=list(FAULTS),
                    choices=FAULTS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmarks import registry
    import torch
    if not torch.cuda.is_available():
        print("[readings] needs a CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    cell = registry.cell(args.workload)
    config = registry.config(registry.entry(bench, args.workload)["config"])
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        line = json.dumps(read_seed(config, cell, seed, device,
                                    args.faults))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
