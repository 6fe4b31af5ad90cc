"""Headline benchmark of the port: SSL training throughput, images/s on
one GPU (counterpart of the repo's bench.py).

    python -m ust_run_tpu_torch.bench [--device cpu] [--deterministic 0]

Times the trainer's own calls (the models and the state built as
`engine/trainer.py` builds them, TF32 off, the UNet under bf16 autocast
on the card) on a synthetic corpus of 256 images held on the device;
each step receives only sampled indices. A call is the trainer's K-step
call, `semisup/step.py:multi_step` of `unroll` steps (on the card: the
step captured once as a CUDA graph, replayed per step), or with
UST_BENCH_UNROLL=1 one eager `step_fn`. Prints ONE line on stdout,
bench.py's JSON object: `metric`, `value` (images/s), `unit`,
`vs_baseline`, `vs_baseline_range`, `baseline_img_per_sec` and
`baseline_basis`. The card's name and power limit, the steps timed and
the uniform-RNG kernel's launches that ran (`ops.rng.launches`: the eager
ones, plus each replay's captured one) and GroupedBatchNorm's
(`ops.grouped_bn.launches`, counted alike) go to stderr.

A call is `unroll` steps fed from one (unroll, batch) draw of indices,
so the batches are those bench.py feeds its multi-step. Warm-up is 3
calls (the first captures the graph); then 8 calls are timed on the host
clock, up to the fetch of the last call's metrics. Each call's metrics
are fetched one call behind, as the trainer fetches them, so the host
never waits on the call it has just queued: images/s = (label_bs +
unlabel_bs) / (window / (8 x unroll)).

Environment (bench.py's variables):
  UST_BENCH_DATASET   fundus (default), prostate, BUSI or MNMS
  UST_BENCH_MODEL     a --model value (default unet)
  UST_BENCH_BATCH     labelled = unlabelled batch (default: the config's)
  UST_BENCH_UNROLL    steps per call (default the config's unroll_steps)
  UST_BENCH_PACK, UST_BENCH_SPLIT
                      accepted and ignored, as the config ignores pack_l1
                      and split_up: layouts of the same UNet
  UST_BENCH_WATCHDOG  seconds before the run gives up (default 900): it
                      then prints the line with value 0.0 and an error,
                      and exits 3.

Baseline: upstream UST-RUN publishes no throughput. The denominator is
BASELINE_METHOD.md's model of the reference on a V100: 20 img/s, range
[13, 31], at the 256 px patch, scaled by pixel count for other patches;
a batch set by UST_BENCH_BATCH has no baseline ratio.
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from ust_run_tpu_torch.config import TrainConfig
from ust_run_tpu_torch.engine.trainer import (Pending, indices_to_device,
                                              set_numerics)
from ust_run_tpu_torch.ops import grouped_bn, rng
from ust_run_tpu_torch.semisup import step as step_mod
from ust_run_tpu_torch.semisup.state import build_model, create_train_state
from ust_run_tpu_torch.semisup.step import HyperParams, unpack_metrics
from ust_run_tpu_torch.utils.device import card_line, resolve_device

METRIC = "ssl_train_images_per_sec_per_chip"
# BASELINE_METHOD.md: the reference on a V100, point estimate and range
REFERENCE_GPU_IMG_PER_SEC = 20.0
REFERENCE_RANGE = (13.0, 31.0)
BASELINE_BASIS = ("BASELINE_METHOD.md (flops model + measured host "
                  "overheads; ref publishes no numbers)")
N_CORPUS = 256
WARMUP_CALLS, TIMED_CALLS = 3, 8


def bench_config(env):
    """(TrainConfig, the batch UST_BENCH_BATCH asks for or 0) from the
    environment mapping `env`, as bench.py:72-99 reads it."""
    cfg = TrainConfig(dataset=env.get("UST_BENCH_DATASET", "fundus")) \
        .resolve()
    cfg.unroll_steps = int(env.get("UST_BENCH_UNROLL", cfg.unroll_steps))
    cfg.model = env.get("UST_BENCH_MODEL", cfg.model)
    bench_bs = int(env.get("UST_BENCH_BATCH", "0"))
    if bench_bs:
        cfg.label_bs = cfg.unlabel_bs = bench_bs
    cfg.pack_l1 = int(env.get("UST_BENCH_PACK", cfg.pack_l1))
    cfg.split_up = int(env.get("UST_BENCH_SPLIT", cfg.split_up))
    return cfg, bench_bs


def result(img_s, cfg, bench_bs):
    """bench.py's output object (bench.py:146-180) for `img_s`."""
    metric = METRIC
    if cfg.dataset != "fundus":
        metric += f"_{cfg.dataset}"
    if cfg.model != "unet":
        metric += f"_{cfg.model}"
    if bench_bs:
        metric += f"_b{bench_bs}"
    # the denominator is derived at the 256 px patch; the cost model is
    # FLOPs-dominated, so it scales by pixel count
    px_scale = (cfg.profile().patch_size / 256.0) ** 2
    base = REFERENCE_GPU_IMG_PER_SEC / px_scale
    lo, hi = (r / px_scale for r in REFERENCE_RANGE)
    out = {
        "metric": metric,
        "value": round(img_s, 2),
        "unit": "images/s",
        "vs_baseline": round(img_s / base, 2),
        "vs_baseline_range": [round(img_s / hi, 2), round(img_s / lo, 2)],
        "baseline_img_per_sec": round(base, 2),
        "baseline_basis": BASELINE_BASIS,
    }
    if bench_bs:
        # the denominator is defined at the reference's 4+4 batch only
        out["vs_baseline"] = None
        out["vs_baseline_range"] = None
        out["baseline_basis"] = (
            "raw img/s only: baseline denominator is defined at the "
            "reference 4+4 batch (BASELINE_METHOD.md), not at bs=%d" %
            bench_bs)
    return out


def label_channels(dataset):
    """Label channels of the synthetic corpus (bench.py:106)."""
    return 3 if dataset == "MNMS" else 1


def make_corpus(rng, n, size, channels, k):
    """bench.py's synthetic corpus (bench.py:101-119), drawn from the
    numpy RandomState `rng` in its order."""
    return {
        "lb_img": rng.randint(0, 256, (n, size, size, channels)
                              ).astype(np.uint8),
        "lb_lab": rng.choice([0, 128, 255], (n, size, size, k)
                             ).astype(np.uint8),
        "ulb_img": rng.randint(0, 256, (n, size, size, channels)
                               ).astype(np.uint8),
        "ulb_lab": rng.choice([0, 128, 255], (n, size, size, k)
                              ).astype(np.uint8),
        "ulb_dc": np.ones(n, np.int32),
    }


def draw_indices(rng, n, unroll, label_bs, unlabel_bs):
    """One call's (unroll, batch) index arrays (bench.py:121-125)."""
    return {"lb_idx": rng.randint(0, n, (unroll, label_bs)
                                  ).astype(np.int32),
            "ulb_idx": rng.randint(0, n, (unroll, unlabel_bs)
                                   ).astype(np.int32)}


class Bench:
    """The benchmark's state, corpus and index stream on one device: the
    trainer's models (weights from torch.Generator seed 0), its train
    state (seed 0) and bench.py's corpus and draws (numpy seed 0)."""

    def __init__(self, cfg, device="cuda"):
        self.device = resolve_device(device)
        set_numerics(cfg.deterministic, cfg.seed)
        self.cfg = cfg
        self.hp = HyperParams.from_config(cfg)
        self.unroll = cfg.unroll_steps
        amp = bool(cfg.amp) and self.device.type == "cuda"
        init = torch.Generator().manual_seed(0)
        student, teacher = (build_model(cfg, self.hp, init, amp)
                            for _ in range(2))
        self.state = create_train_state(self.hp, 0, self.device, student,
                                        teacher)
        self.rng = np.random.RandomState(0)
        corpus = make_corpus(self.rng, N_CORPUS, self.hp.patch,
                             self.hp.channels, label_channels(cfg.dataset))
        self.data = {k: torch.from_numpy(v).to(self.device)
                     for k, v in corpus.items()}
        self.steps = 0

    def calls(self, n):
        """`n` calls of `unroll` steps. Each call's metrics are fetched
        after the next call is queued, the last one at the end; returns
        the last step's metrics (numpy)."""
        hp, pending = self.hp, None
        for _ in range(n):
            idx = indices_to_device(
                draw_indices(self.rng, N_CORPUS, self.unroll, hp.label_bs,
                             hp.unlabel_bs), self.device)
            if self.unroll == 1:
                metrics = step_mod.step_fn(
                    self.state, self.data, {k: v[0] for k, v in idx.items()},
                    hp)
            else:
                feeds = step_mod.host_to_device(
                    step_mod.draw_feeds(self.state, hp, self.unroll),
                    self.device)
                metrics = step_mod.multi_step(self.state, self.data, idx,
                                              feeds, hp)
            self.steps += self.unroll
            if pending is not None:
                pending.fetch()
            pending = Pending(self.steps, metrics, None)
        return pending.fetch().reshape(self.unroll, -1)[-1]


def measure(bench, warmup_calls=WARMUP_CALLS, timed_calls=TIMED_CALLS):
    """(images/s, the last step's metrics) over `timed_calls` calls after
    `warmup_calls`, host clock, the window ending with the last fetch."""
    bench.calls(warmup_calls)
    t0 = time.perf_counter()
    last = bench.calls(timed_calls)
    dt = (time.perf_counter() - t0) / (timed_calls * bench.unroll)
    return (bench.hp.label_bs + bench.hp.unlabel_bs) / dt, last


def _watchdog(secs, done):
    if done.wait(secs):
        return
    print(json.dumps({
        "metric": METRIC,
        "value": 0.0,
        "unit": "images/s",
        "vs_baseline": 0.0,
        "error": f"the benchmark did not finish within {secs} s (CUDA "
                 "initialisation, the kernel build or a step did not "
                 "return); no throughput was measured",
    }), flush=True)
    os._exit(3)


def start_watchdog(secs):
    """A daemon thread that prints the error line and ends the process
    with code 3 unless the returned event is set within `secs` seconds."""
    done = threading.Event()
    threading.Thread(target=_watchdog, args=(secs, done),
                     daemon=True).start()
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--deterministic", type=int, default=1,
                    help="the train entry's flag: 1 (default) deterministic "
                    "cuDNN, 0 cuDNN's benchmarked choice")
    args = ap.parse_args(argv)
    done = start_watchdog(int(os.environ.get("UST_BENCH_WATCHDOG", "900")))
    try:
        cfg, bench_bs = bench_config(os.environ)
        cfg.deterministic = args.deterministic
        bench = Bench(cfg, args.device)
        step_mod.reset_counts()
        img_s, last = measure(bench)
    finally:
        done.set()
    launches = rng.launches
    on_card = bench.device.type == "cuda"
    if on_card and launches != bench.steps:
        raise RuntimeError(f"uniform_rng launched {launches} times in "
                           f"{bench.steps} steps")
    hp = bench.hp
    print("[bench] " + json.dumps({
        "card": card_line(bench.device), "dataset": cfg.dataset,
        "model": cfg.model, "batch": [hp.label_bs, hp.unlabel_bs],
        "patch": hp.patch, "unroll": bench.unroll,
        "deterministic": cfg.deterministic,
        "warmup_steps": WARMUP_CALLS * bench.unroll,
        "steps_timed": TIMED_CALLS * bench.unroll,
        "steps_run": bench.steps,
        # the CPU runs the kernel's plain version, which is no launch
        "uniform_rng_launches": launches if on_card else None,
        "grouped_bn_launches": grouped_bn.launches if on_card else None,
        "graph_captures": step_mod.graph_counts["captures"],
        "graph_replays": step_mod.graph_counts["replays"],
        "last_loss": float(unpack_metrics(last, hp)["loss"])}),
        file=sys.stderr, flush=True)
    print(json.dumps(result(img_s, cfg, bench_bs)), flush=True)


if __name__ == "__main__":
    main()
