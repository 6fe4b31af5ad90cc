"""The port's benchmark entry (ust_run_tpu_torch/bench.py) against the
repo's bench.py: its environment gives bench.py's metric names and
baseline fields, its corpus and index draws are bench.py's, the state its
steps leave is bit-equal to the trainer's step_fn driven on the same index
rows, and it refuses to run (or to go on) without printing a number it
did not measure. Patch 32 on the CPU, the UNet at its fixed widths."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_threads import single_thread  # noqa: F401
from ust_run_tpu_torch import bench
from ust_run_tpu_torch.config import (TrainConfig, build_parser,
                                      config_from_args)
from ust_run_tpu_torch.semisup.state import build_model, create_train_state
from ust_run_tpu_torch.semisup.step import HyperParams, step_fn

pytestmark = pytest.mark.usefixtures("single_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASIS = ("BASELINE_METHOD.md (flops model + measured host overheads; ref "
         "publishes no numbers)")
# bench.py:148-180 at 100 img/s: 20 img/s (range 13-31) at 256 px, scaled
# by (patch / 256)^2; prostate is 384 px, MNMS 288 px
FUNDUS = (20.0, 5.0, [3.23, 7.69])
TABLE = [
    ({}, "", FUNDUS),
    ({"UST_BENCH_DATASET": "BUSI"}, "_BUSI", FUNDUS),
    ({"UST_BENCH_DATASET": "prostate"}, "_prostate",
     (8.89, 11.25, [7.26, 17.31])),
    ({"UST_BENCH_DATASET": "MNMS"}, "_MNMS", (15.8, 6.33, [4.08, 9.74])),
    ({"UST_BENCH_MODEL": "deeplabv2_r50"}, "_deeplabv2_r50", FUNDUS),
    ({"UST_BENCH_BATCH": "8"}, "_b8", (20.0, None, None)),
    ({"UST_BENCH_DATASET": "MNMS", "UST_BENCH_MODEL": "deeplabv2_r50",
      "UST_BENCH_BATCH": "2"}, "_MNMS_deeplabv2_r50_b2",
     (15.8, None, None)),
    ({"UST_BENCH_PACK": "0"}, "", FUNDUS),
    ({"UST_BENCH_SPLIT": "0"}, "", FUNDUS),
]


@pytest.mark.parametrize("env,suffix,want", TABLE,
                         ids=[json.dumps(e) for e, _, _ in TABLE])
def test_metric_names_and_baseline(env, suffix, want):
    cfg, bench_bs = bench.bench_config(env)
    base, vs, vs_range = want
    out = bench.result(100.0, cfg, bench_bs)
    assert list(out) == ["metric", "value", "unit", "vs_baseline",
                         "vs_baseline_range", "baseline_img_per_sec",
                         "baseline_basis"]
    assert out["metric"] == "ssl_train_images_per_sec_per_chip" + suffix
    assert (out["value"], out["unit"]) == (100.0, "images/s")
    assert out["baseline_img_per_sec"] == base
    assert out["vs_baseline"] == vs
    assert out["vs_baseline_range"] == vs_range
    if bench_bs:
        assert out["baseline_basis"] == (
            "raw img/s only: baseline denominator is defined at the "
            f"reference 4+4 batch (BASELINE_METHOD.md), not at bs={bench_bs}")
    else:
        assert out["baseline_basis"] == BASIS
    # the step the knobs select: batch, model and unroll; PACK and SPLIT
    # are layouts of the same UNet and leave the step as it is
    hp = HyperParams.from_config(cfg)
    bs = int(env.get("UST_BENCH_BATCH", 4))
    assert (hp.label_bs, hp.unlabel_bs) == (bs, bs)
    assert cfg.model == env.get("UST_BENCH_MODEL", "unet")
    assert cfg.unroll_steps == 10
    default_cfg, _ = bench.bench_config({})
    if set(env) <= {"UST_BENCH_PACK", "UST_BENCH_SPLIT"}:
        assert hp == HyperParams.from_config(default_cfg)


def test_unroll_and_mnms_profile():
    cfg, _ = bench.bench_config({"UST_BENCH_UNROLL": "2"})
    assert cfg.unroll_steps == 2
    # MNMS through the plain config is the train_mnms entry's profile
    cfg, _ = bench.bench_config({"UST_BENCH_DATASET": "MNMS"})
    hp = HyperParams.from_config(cfg)
    mnms = config_from_args(build_parser(mnms=True).parse_args([])).resolve()
    assert hp == HyperParams.from_config(mnms)
    assert (hp.patch, hp.channels, hp.num_classes) == (288, 1, 4)


def recipe(rng, n, s, c, k, unroll, bs, calls):
    """bench.py:101-125 in numpy: the corpus, then `calls` index draws."""
    data = {
        "lb_img": rng.randint(0, 256, (n, s, s, c)).astype(np.uint8),
        "lb_lab": rng.choice([0, 128, 255], (n, s, s, k)).astype(np.uint8),
        "ulb_img": rng.randint(0, 256, (n, s, s, c)).astype(np.uint8),
        "ulb_lab": rng.choice([0, 128, 255], (n, s, s, k)).astype(np.uint8),
        "ulb_dc": np.ones(n, np.int32),
    }
    draws = [{"lb_idx": rng.randint(0, n, (unroll, bs)).astype(np.int32),
              "ulb_idx": rng.randint(0, n, (unroll, bs)).astype(np.int32)}
             for _ in range(calls)]
    return data, draws


@pytest.mark.parametrize("dataset,k", [("fundus", 1), ("MNMS", 3)])
def test_corpus_and_draws_are_bench_py_recipe(dataset, k):
    s, c = 12, (3 if dataset == "fundus" else 1)
    assert bench.label_channels(dataset) == k
    want, want_draws = recipe(np.random.RandomState(0), 256, s, c, k, 3, 4, 2)
    rng = np.random.RandomState(0)
    got = bench.make_corpus(rng, 256, s, c, k)
    draws = [bench.draw_indices(rng, 256, 3, 4, 4) for _ in range(2)]
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for d, w in zip(draws, want_draws):
        for key in w:
            np.testing.assert_array_equal(d[key], w[key])


def _state_tensors(state):
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    for i, p in enumerate(state.student.parameters()):
        out[f"momentum.{i}"] = state.optimizer.state[p]["momentum_buffer"]
    out.update({f"queue.{k}": v for k, v in state.queue.fields().items()})
    out.update({"lq.img": state.lq.img, "lq.pl": state.lq.pl,
                "lq.conf": state.lq.conf, "lq.valid": state.lq.valid,
                "choice_th": state.choice_th})
    return out


def test_bench_times_the_trainers_step():
    """`measure` at unroll 1, one warm-up and 2 timed calls, returns a
    finite rate; the state it leaves is bit-equal to step_fn driven on
    bench.py's index rows in order from the same seeds."""
    cfg = TrainConfig(dataset="fundus", patch_override=32).resolve()
    cfg.unroll_steps = 1
    b = bench.Bench(cfg, "cpu")
    hp = b.hp
    corpus, draws = recipe(np.random.RandomState(0), 256, 32, 3, 1, 1, 4, 3)
    for key, v in corpus.items():
        assert torch.equal(b.data[key], torch.from_numpy(v)), key
    img_s, last = bench.measure(b, warmup_calls=1, timed_calls=2)
    assert math.isfinite(img_s) and img_s > 0
    assert b.steps == 3 and b.state.step == 3

    init = torch.Generator().manual_seed(0)
    models = [build_model(cfg, hp, init, False) for _ in range(2)]
    state = create_train_state(hp, 0, torch.device("cpu"), *models)
    data = {k: torch.from_numpy(v) for k, v in corpus.items()}
    for d in draws:
        idx = {k: torch.from_numpy(v[0].astype(np.int64))
               for k, v in d.items()}
        want_last = step_fn(state, data, idx, hp).numpy()
    np.testing.assert_array_equal(last, want_last)
    got, want = _state_tensors(b.state), _state_tensors(state)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _run_entry(argv, env):
    return subprocess.run(
        [sys.executable, "-m", "ust_run_tpu_torch.bench", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, **env})


def test_entry_without_card_prints_no_number():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry would run on it")
    out = _run_entry([], {})
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert '"value"' not in out.stdout


def test_watchdog_prints_the_error_line_and_exits_3():
    out = _run_entry(["--device", "cpu"], {"UST_BENCH_WATCHDOG": "0"})
    assert out.returncode == 3, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "ssl_train_images_per_sec_per_chip"
    assert (line["value"], line["vs_baseline"]) == (0.0, 0.0)
    assert "did not finish within 0 s" in line["error"]
    assert "TPU" not in line["error"]
