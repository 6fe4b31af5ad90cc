"""The port's long training runs on one card, and the per-epoch table of a
training log.

    python -m ust_run_tpu_torch.parity_runs run --work DIR --out OUT \
        [--seeds 1337 1338 1339 1340 1341] [--long-iters 4000] \
        [--n-train 8] [-- <more train flags>]
    python -m ust_run_tpu_torch.parity_runs table LOG [LOG ...]

`run` writes the synthetic fundus corpus with data.synthetic's defaults
(n_train 8, n_test 3, seed 0; `--n-train` sets the training images per
domain) under WORK, then trains through
`python -m ust_run_tpu_torch.train`, one process per run, on the card:
  * the PARITY.md lanes, one per seed: fundus, `--lb_domain 1 --lb_num 8
    --num_eval_iter 25 --eval_batch 4` on the default 30k schedule, cut
    by UST_STOP_AFTER_ITERS at LANE_ITERS (200, the PARITY.md horizon);
  * one long run: the same flags with `--num_eval_iter 500 --seed 1337`,
    cut at `--long-iters`, with UST_WNORM_LOG=1 and UST_NAN_DEBUG under
    WORK; a dump there (exit code 3) is replayed at once by
    `python -m ust_run_tpu_torch.nan_replay`, whose output goes to OUT.
Each run's log.txt goes gzipped to OUT (`port_fundus_seed<S>_log.txt.gz`,
`port_fundus_long_log.txt.gz`) with the exit codes in OUT/runs.json;
checkpoints and dumps stay in WORK, which is removed at the end.

`table` reads a training log of either package (the same format) and
prints one markdown row per epoch: images/s and the largest |parameter|
and |BN statistic| of the weight-health lines (and the first layer's,
`inc`). The dice of each evaluation, the lanes' per-seed bests, medians
and bands come from tools/parity_multiseed.py, the one parser of the
evaluation blocks.
"""

import argparse
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import time

LANE_ITERS = 200
LANE_FLAGS = ["--dataset", "fundus", "--lb_domain", "1", "--lb_num", "8",
              "--eval_batch", "4", "--overwrite"]


def train(work, name, flags, env, out, extra):
    """One `python -m ust_run_tpu_torch.train` run; its log gzipped to
    OUT. Returns (exit code, seconds)."""
    t0 = time.time()
    rc = subprocess.run(
        [sys.executable, "-m", "ust_run_tpu_torch.train", *LANE_FLAGS,
         "--data_root", os.path.join(work, "data", "Fundus"),
         "--model_root", os.path.join(work, "model"), "--save_name", name,
         *flags, *extra], env={**os.environ, **env},
        stdout=subprocess.DEVNULL, check=False).returncode
    log = os.path.join(work, "model", "fundus", name, "log.txt")
    with open(log, "rb") as f, \
            gzip.open(os.path.join(out, f"port_{name}_log.txt.gz"),
                      "wb") as g:
        shutil.copyfileobj(f, g)
    return rc, time.time() - t0


def run(args):
    from ust_run_tpu_torch.data.synthetic import generate
    os.makedirs(args.out, exist_ok=True)
    shutil.rmtree(args.work, ignore_errors=True)
    generate("fundus", os.path.join(args.work, "data", "Fundus"),
             n_train=args.n_train)
    card = "no nvidia-smi"
    if shutil.which("nvidia-smi"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    report = {"card": card, "n_train": args.n_train, "runs": {}}
    try:
        for seed in args.seeds:
            name = f"fundus_seed{seed}"
            rc, secs = train(args.work, name,
                             ["--num_eval_iter", "25", "--seed", str(seed)],
                             {"UST_STOP_AFTER_ITERS": str(LANE_ITERS)},
                             args.out, args.extra)
            report["runs"][name] = {"rc": rc, "seconds": secs}
            print(f"[lane] seed {seed}: rc {rc}, {secs:.1f} s", flush=True)
        if args.long_iters:
            dump = os.path.join(args.work, "nan")
            flags = ["--num_eval_iter", "500", "--seed", "1337"]
            rc, secs = train(args.work, "fundus_long", flags,
                             {"UST_STOP_AFTER_ITERS": str(args.long_iters),
                              "UST_WNORM_LOG": "1", "UST_NAN_DEBUG": dump},
                             args.out, args.extra)
            report["runs"]["fundus_long"] = {"rc": rc, "seconds": secs}
            print(f"[long] rc {rc}, {secs:.1f} s", flush=True)
            if rc == 3:
                with open(os.path.join(args.out, "nan_replay.txt"),
                          "w") as f:
                    report["replay_rc"] = subprocess.run(
                        [sys.executable, "-m", "ust_run_tpu_torch.nan_replay",
                         "--dump", dump, "--", *LANE_FLAGS, "--data_root",
                         os.path.join(args.work, "data", "Fundus"),
                         "--model_root", os.path.join(args.work, "replay"),
                         *flags, *args.extra], stdout=f,
                        stderr=subprocess.STDOUT, check=False).returncode
    finally:
        with open(os.path.join(args.out, "runs.json"), "w") as f:
            json.dump(report, f, indent=1)
        shutil.rmtree(args.work, ignore_errors=True)
    return 0 if all(r["rc"] == 0 for r in report["runs"].values()) else 1


EPOCH = re.compile(r"^epoch (\d+): [\d.]+ it/s, ([\d.]+) images/s", re.M)
HEALTH = re.compile(r"^epoch (\d+) weight health: (params|bn) max (.*)$",
                    re.M)


def epochs(text):
    """{epoch: {"img_s", "params", "bn" (module -> max)}} from a
    training log's text."""
    text = re.sub(r"^\[[0-9:.]+\] ", "", text, flags=re.M)
    rows = {}
    for m in EPOCH.finditer(text):
        rows.setdefault(int(m.group(1)), {})["img_s"] = float(m.group(2))
    for m in HEALTH.finditer(text):
        rows.setdefault(int(m.group(1)), {})[m.group(2)] = {
            k: float(v) for k, v in
            (kv.split(":") for kv in m.group(3).split())}
    return rows


def table(args):
    for path in args.logs:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            rows = epochs(f.read())
        print(f"\n{path}\n")
        print("| epoch | images/s | params max (inc) | bn max (inc) |")
        print("|---|---|---|---|")
        for e in sorted(rows):
            r, cells = rows[e], []
            for k in ("params", "bn"):
                cells.append(f"{max(r[k].values()):.3e} ({r[k]['inc']:.3e})"
                             if k in r else "-")
            print(f"| {e} | {r.get('img_s', '-')} | " + " | ".join(cells)
                  + " |")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--work", required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--seeds", type=int, nargs="*",
                   default=[1337, 1338, 1339, 1340, 1341])
    r.add_argument("--long-iters", type=int, default=4000)
    r.add_argument("--n-train", type=int, default=8)
    r.add_argument("extra", nargs="*", help="more train flags, after --")
    t = sub.add_parser("table")
    t.add_argument("logs", nargs="+")
    args = ap.parse_args(argv)
    return run(args) if args.cmd == "run" else table(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
