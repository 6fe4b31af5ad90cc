#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ust_run_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile FILE]
    python3 chip_smoke.py --ab TREE[@nccl] ... [--profile FILE]

Phases, one line each (or a few); any failure exits non-zero:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel library from the checkout at once
     (nvcc for sm_90a: csrc/uniform_rng.cu, csrc/fused_conv.cu and
     csrc/grouped_bn.cu; g++ for the boundary-metric engine
     native/boundary.cc) and prints what ptxas reports for each
     fused_conv and grouped_bn kernel (registers, spills);
  3. kernels: each kernel against its plain PyTorch version on the card,
     TF32 off, with its time, its bound and the time of the nearest
     PyTorch library call or chain:
     - the uniform-field RNG bit-equal at the main path's shape and at a
       ragged one, and the statistical bar (keys with the high words set
       and keys rewritten between graph replays in phase 17, its time in
       phase 18);
     - bn_relu_conv3x3 at the JAX test shapes and at three edge shapes
       (ragged image edges, a partial last K chunk with C > 64, a partial
       N tile of 128 channels; C = 3, Co = 70) in f32 and bf16 (both of
       the library's routes: TMA + wgmma for bf16 with C, Co multiples
       of 8, WMMA otherwise, each of which must launch), the
       all-ones edge case (exact 4C/6C/9C counts) and the four microbench
       shapes of tools/bench_fused_conv.py in bf16 (f32 `out` to 1e-4:
       accumulation order over K up to 576; bf16 `out` within one bf16
       ulp of the plain value plus 1e-5 of its largest magnitude, where
       near-cancelling sums let the f32 order move the rounding; moments
       to rtol 1e-5, atol 1e-5 of their largest magnitude, a bar that
       must be narrower than what one tile dropped from the moments'
       tile reduce would lose at every microbench shape, at the tile
       geometry the library reports for the route); then its
       path, the microbench at those shapes: kernel, plain version and
       `reference_chain` (BN+ReLU pass, cuDNN bf16 convolution, moment
       passes: the chain the kernel replaces), with bound, TFLOP/s and
       GB/s;
     - GroupedBatchNorm's four passes (csrc/grouped_bn.cu: moments,
       apply+ReLU, gradient sums, input gradient) at GBN_SHAPES against
       their plain versions (sums within 1e-5 of the sum of their terms'
       magnitudes; elementwise outputs within one ulp of the output's
       type plus 4 float32 ulp of their terms' magnitudes), the sums of
       two runs bit-equal; each timed on the device (calls captured in a
       CUDA graph, the replay timed by CUDA events) beside its byte bound
       at 3.35 TB/s and its plain version, and the layer's forward and
       backward with the ReLU beside the operator chain it replaced;
  4. reference: the port's UNet train forward and gradients on the card
     against the same module on the CPU (float32, TF32 off) at a small
     input; then the fused SGD: one SGD(fused=True) update of the UNet's
     parameters on the card (the step's route there) against the CPU's
     unfused update from equal parameters, gradients, momentum and lr,
     within SGD_ULP float32 ulp;
  5. main path: the port's trainer on a synthetic fundus corpus at full
     width (UNet 64->1024, 3x256^2, batch 4+4) at its default
     --unroll_steps 10: a warm-up call of 3 steps (the first runs eagerly,
     then the step is captured as a CUDA graph and replayed) and 10 timed
     steps (replays), every loss finite, the RNG kernel run once per
     step (launches outside graphs plus the captured one per replay),
     GroupedBatchNorm's passes (ops/grouped_bn.py, counted alike) the same
     number of times every step, and
     no call in the timed steps that makes the host wait on the card
     (`torch.cuda.set_sync_debug_mode("error")`) other than the trainer's
     one-call-behind metric fetch;
  6. profile (only with --profile FILE): 5 more steps of the same trainer
     under torch.profiler: wall and device-kernel ms per step, the
     device's busy share, kernel launches per step, the host's time
     blocked in synchronising CUDA calls, the top operators by device
     time and the convolutions' FLOPs; written to FILE as JSON; the same
     for a trainer at --unroll_steps 1 (eager steps) to FILE's stem +
     `_eager.json`, and for the zoo path of phase 10 to FILE's stem +
     `_zoo.json`;
  7. evaluation, on the same trainer: after one untimed warm-up pass, the
     EMA and student models timed over the synthetic fundus test split
     (32 images) at full width, every per-domain dice in [0, 1] and dc,
     jc, hd95, asd finite; a checkpoint
     written to `_smoke/`, a fresh trainer built with --load from it
     (state_dicts, SGD state and queue equal to the saved ones, its
     evaluation equal to the first within 1e-6), and
     `python -m ust_run_tpu_torch.test` on the saved best model;
  8. BUSI: the softmax profile at full width (1x256^2, batch 4+4): 3
     steps with every loss finite, then one evaluation of both models;
  9. zoo reference: DeepLabV2 on the dilated ResNet-101, train forward
     and head gradients on the card against the same module on the CPU
     (float32, TF32 off) at a small input, phase 4's bar of 1e-3 taken
     as a share of the largest magnitude for the forward too;
 10. zoo path: `--model deeplabv2` (ResNet-101, output stride 8) through
     the trainer on the fundus corpus at full width, float32: a seeded
     torchvision-layout `resnet101.pth` as `--pretrained_root` (the
     overlay's log line; both backbones equal the file), 3 warm-up and
     10 timed steps (timed ones under the sync debug mode), every loss
     finite, the RNG kernel once per step; then one evaluation of both
     models, a checkpoint resumed with --load (state equal), and
     `python -m ust_run_tpu_torch.test --model deeplabv2 --save_img`
     (one overlay PNG per test image);
 11. zoo, short: 3 steps each, every loss finite, of `deeplabv2_r50` and
     `unet2d` on fundus and `unet2d` on BUSI;
 12. prostate and MNMS: the RNG kernel bit-equal at their field shapes
     (16,384,384) and (16,288,288); the UNet at full width on prostate
     (1x384^2) for 3 steps and one evaluation of both models, and on
     MNMS (1x288^2, 4 classes) through the `train_mnms` entry for 3
     steps and its epoch-end evaluation and checkpoint;
 13. data parallel (ust_run_tpu_torch.parallel), fundus at phase 5's
     full width: (a) a one-rank NCCL process group at the default
     --unroll_steps 10, the step captured with its collectives as one
     CUDA graph: 33 steps (a capturing call of 3, 30 replays under the
     sync debug mode) whose metric rows and state must be bit-equal to 33
     eager NCCL steps and to the graph path with no process group from
     the same seed, uniform_rng once per step (img/s beside phase 5's;
     with --profile, the host's idle share of the NCCL step, eager and on
     the graph, each profiled in a fresh process as `--ab` runs); (b) two ranks spawned on cuda:0 under Gloo, 3 steps: the
     replicas bit-equal (a max-abs-difference all-reduce reads 0), every
     loss finite, uniform_rng once per step per rank, the first step's
     losses and the state after 3 steps within DP_LOSS_RTOL and
     DP_UPDATE_SHARE of world 1, and a control run of the same ranks with
     the mean of their local losses planted must miss DP_UPDATE_SHARE;
     its img/s is two processes sharing one card, not a scaling figure;
     (c) the same two ranks on
     `deeplabv2_r50`, float32, 3 steps: replicas bit-equal, and one
     sharded evaluation equal to each rank's evaluation of every sample
     alone within 1e-6;
 14. instruments, fundus at phase 5's full width: (a) the train entry
     with UST_STOP_AFTER_ITERS=6 and epochs of 3 stops after two
     evaluations, its last lr that of the 30k budget; (b) its
     UST_WNORM_LOG lines are there and finite; (d) its --profile_dir trace
     holds the RNG kernel's two launches of steps 2-3; (c) a
     `--base_lr 300` run of the entry exits 3 with a UST_NAN_DEBUG dump
     (UST_NAN_SNAP 2), and `python -m ust_run_tpu_torch.nan_replay`
     reproduces its failing iteration on the card (exit 1) and names the
     first module with a non-finite output;
 15. spatial (ust_run_tpu_torch.parallel with a space axis: row slabs
     of 16-row blocks, halo rows for every operation spanning rows),
     fundus at phase 5's full width, Gloo ranks spawned on cuda:0: (a) a
     1 x 2 mesh
     (data 1 x space 2), bf16, DP_STEPS steps: the replicas bit-equal,
     every loss finite, uniform_rng once per step per rank, the first
     step's losses and the state after the steps within DP_LOSS_RTOL and
     DP_UPDATE_SHARE of world 1; and one float32 step whose gradient lies
     within DP_GRAD_SHARE of world 1's; (b) the same runs with the halo
     rows zeroed must miss one of those bars (at full width only the
     float32 gradient's does: two rows in 256 barely move a bf16 loss);
     (c) a 2 x 2 mesh on four ranks, float32, one step, whose gradient
     must lie within DP_GRAD_SHARE of world 1's; then the zoo, float32,
     one step each, the head's gradient (DeepLab's ASPP, Unet2D's seg1)
     within DP_GRAD_SHARE of world 1's, the replicas bit-equal,
     uniform_rng once per rank, and the same step with every halo zeroed
     beyond the bar: (d) DeepLabV2-R101 on 1 x 2, (e) on 1 x 4 (the
     ASPP's 24-row halo crosses three 8-row slabs), (f) Unet2D on 1 x 2;
     the whole gradient's distance printed beside the data axis's alone
     (2 x 1), which these models' ReLUs keep above the bar. Its img/s
     and peak GiB are several processes sharing one card, not a scaling
     figure;
 16. bench, each run in a fresh process: `python -m
     ust_run_tpu_torch.bench` at its defaults (fundus UNet, 3 x 10 warm-up
     and 8 x 10 timed steps) and with UST_BENCH_MODEL=deeplabv2_r50
     UST_BENCH_UNROLL=2: one stdout line, bench.py's JSON with the metric's
     name and a finite rate above 0, and on stderr uniform_rng launched once
     per step run (one capture and a replay per other step at unroll
     above 1) and a finite last loss; then, in this process, one bench
     step after a warm-up step under the sync debug mode, its index copy
     and lagged fetch included, whose stage clock (utils/trace.py) must
     count each clocked span of the step once on the eager path, with a
     positive time; the stamp kernel's arithmetic on known device work
     (`torch.cuda._sleep` spins inside `step.inputs` and a nested
     `step.teacher_fwd`, timed by CUDA events between the stamps): each
     span's self time within STAGE_RTOL of its spins' event time, the
     outer span's without the inner one's, and their sum within
     STAGE_RTOL of the block's, run eagerly and as 5 replays of a
     captured graph (counted 5 times on the graph path alone); and a
     bench at 10 steps a call, where after a capturing call 2 calls
     count 20 replays in `graph_counts` and 20 in each clocked span on
     the graph path, nothing on the eager path, with the stages summing
     to within STAGE_RTOL of the calls' CUDA-event time;
 17. unroll (`--unroll_steps`, one captured CUDA graph of the step
     replayed per step): (a) the RNG kernel, which reads its key from
     device memory, bit-equal to its plain version for keys with the
     high words 0x5EED, 0x80000000 and 0xFFFFFFFF; in a captured graph
     two replays with two keys draw those keys' fields, and the control,
     a key tensor made at capture and never rewritten, draws equal fields
     and must fail that check; (b)
     fundus at full width, bf16, 33 steps on the graph path (a capturing
     call of 3, then 3 calls of 10 replays) against 33 eager steps of a
     trainer from the same seed: every metric row and state tensor
     bit-equal; the zoo in float32 (ZOO_PAIRS): deeplabv2_r50 and unet2d
     a capturing call of one step and two replays, each replayed step
     against the same step run twice eagerly from the state before it
     (restored in place, which the graph must survive), deeplabv2 (R101)
     one replayed step against one eager run: every metric row and state
     tensor bit-equal (the zoo's step is run-to-run deterministic under
     --deterministic 1); (c) the replays under the sync debug mode; (d)
     peak GiB, graph against eager; and a torch.profiler window (CUDA activity) of
     10 replays holding 10 uniform_fields_kernel by name (9: the profiler
     can miss a kernel);
 18. RNG timing: the uniform-field RNG's (its key on the card) and
     torch.rand's device time per kernel (torch.profiler) apart from
     the host's cost per call (host clock). Last, so that no phase timed
     before it runs in a process that torch.profiler has traced.
Each phase prints its wall time. Then a JSON line with the kernels'
numbers, the card line again, and `{"ok": true, "device": {...}}` as the
last line.

`--ab` runs only the main path, tree against tree on one card: for each
TREE (a checkout of the repo, e.g. `git archive <commit>` unpacked under
the ignored `_ab/`), in the order given, a fresh process puts TREE's
package first on the path and times phase 5's trainer over AB_STEPS
steps (`TREE@nccl`: on a one-rank NCCL process group, for a tree that
has ust_run_tpu_torch.parallel; `TREE@nccl-eager`: the same at
--unroll_steps 1), with `--profile FILE` also phase 6's
profile (to FILE's stem + `_<i>.json`, with the operators that take
the most host time). One JSON line per run. Interleave the trees (A B B
A) to compare them within one call.

`--memory FILE` runs only one float32 step at world 1 of the fundus UNet
and one of DeepLabV2-R101, each after a warm-up step, with
torch.cuda.memory's history recorded, and prints and writes to FILE
(JSON) the allocations live at each step's peak, largest first, by the
port's innermost frame that made them.

Synthetic data, the trainer's log and the kernel build stay inside the
checkout (`_smoke/`, `ust_run_tpu_torch/_build/`); `_smoke/` is removed
at the end.
"""

import argparse
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_NONTENSOR_OPS_PER_S = 67e12  # f32 outside the tensor cores (proxy for
#                                   32-bit integer work)
PHILOX_OPS_PER_QUAD = 112        # 10 rounds x (2 mulhi + 2 mullo + 4 xor +
#                                  2 key adds) + 4 x (shift, convert, scale)
H100_BF16_FLOPS = 989e12          # dense bf16 tensor cores, data sheet
MOMENT_RTOL = 1e-5                # bn_relu_conv3x3 moments: rtol, and atol
#                                   as a share of the largest magnitude
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS, BUSI_STEPS = 3, 10, 5, 3
SHORT_STEPS = 3                   # zoo short, prostate and MNMS phases
DP_STEPS = 3                      # data-parallel phase: steps per run
AB_STEPS = 30                     # --ab: timed steps per run
# two ranks vs world 1 at bf16 (phase 13 b): the first step's losses to one
# bf16 ulp, relative (2^-8); after DP_STEPS steps, the distance to world 1
# as a share of how far the steps moved each state. An N-fold gradient
# misses by 100% and more; the mean of the ranks' local losses only just
# (6.4e-2 on the momentum against the port's 9.9e-3, H100, PERF.md)
DP_LOSS_RTOL = 2.0 ** -8
DP_UPDATE_SHARE = 0.05
# the same at float32, one step: the gradient's distance to world 1's as a
# share of its norm, which separates the two (H100: 1.6e-4 for the port,
# 4.0e-3 with the mean of the ranks' local losses planted; the phase
# plants it as a control, which must miss this bar)
DP_GRAD_SHARE = 1e-3
# the card's fused SGD update against the CPU's unfused one: float32 ulp of
# the largest operand of the last operation (the momentum: 0.9 m and the
# decayed gradient; the parameter: p and lr x momentum); each side rounds
# at most twice along the way, FMA or not
SGD_ULP = 4
N_TEST = 8                        # synthetic test images per domain
LOSSES = ("loss", "sup_loss", "unsup_loss_ul", "unsup_loss_lu",
          "unsup_loss_s")
RESNET101 = (3, 4, 23, 3)
FUSED_TEST_SHAPES = [(2, 16, 16, 8, 8), (1, 32, 24, 16, 8),
                     (1, 16, 16, 64, 16)]        # tests/test_fused_conv.py
# (B, H, W, C, Co) the TMA route's masks meet: ragged image edges, a
# partial last K chunk with C > 64 (136 = 2 x 64 + 8) and a partial second
# N tile at N tile 128 (200 = 128 + 72; 72 = 64 + 8); C = 3, Co = 70 go
# the other route
FUSED_EDGE_SHAPES = [(2, 40, 50, 136, 200), (2, 19, 37, 64, 72),
                     (2, 19, 37, 3, 70)]
# (label, B, H, W, C, Co): the fused step's conv shapes timed by
# tools/bench_fused_conv.py:34-39 (21 = the student megabatch, 12 = the
# teacher's three groups of 4)
FUSED_SHAPES = [("L1 student", 21, 256, 256, 64, 64),
                ("L1 teacher", 12, 256, 256, 64, 64),
                ("L2 student", 21, 128, 128, 128, 128),
                ("L3 student", 21, 64, 64, 256, 256)]
RNG_SHAPE = (16, 256)             # the main path's fields: (n, S)
# GroupedBatchNorm's passes: (n, c, h, w, dtype, group sizes) of the
# UNet's L1 student call, its deepest teacher call, an R101 layer-3
# student call (the dtype is filled in where torch is imported)
GBN_SHAPES = [("unet L1 student", (21, 64, 256, 256, "bfloat16",
                                   (4, 4, 4, 4, 4, 1))),
              ("unet L5 teacher", (12, 1024, 16, 16, "bfloat16",
                                   (4, 4, 4))),
              ("r101 L3 student", (21, 1024, 32, 32, "float32",
                                   (4, 4, 4, 4, 4, 1)))]
RNG_SEED = 0x5EED_0F_F1E1D5
# phase 14 (c): a --base_lr that drives the loss non-finite within a few
# steps (step 8 on the H100, 6 at patch 32 on the CPU), and the iterations
# it may take
NAN_LR, NAN_MAX_ITERS = "300", 30
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def reset_launches():
    """Zero uniform_rng's launch count and the step graph's counts."""
    from ust_run_tpu_torch.semisup import step
    step.reset_counts()


def rng_launches():
    """uniform_rng launches that ran since `reset_launches`
    (`ops.rng.launches`: the wrapper's launches outside a capture, plus,
    for each replay of a captured step, the launches captured in it)."""
    from ust_run_tpu_torch.ops import rng
    return rng.launches


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """ms per call of `reps` back-to-back calls, CUDA events around them,
    after 3 warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Device ms per call of fn: `reps` calls captured as one CUDA graph
    (after 3 warm-up calls on a side stream), the graph's replay timed by
    CUDA events, so that the host's cost of a call, which dominates a
    small pass run eagerly, is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def profiled_us(fn, reps):
    """(mean device µs per call, kernels per call) of `reps` calls of fn,
    from the durations torch.profiler records for the CUDA kernels they
    launch; fails if it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda
               and not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        fail("torch.profiler recorded no CUDA kernel")
    return (sum(e.time_range.elapsed_us() for e in kernels) / reps,
            len(kernels) / reps)


def host_us(fn, batches=21, per_batch=50):
    """The host's least µs per call over `batches` batches of `per_batch`
    back-to-back calls of fn, host clock, the card synchronised between
    batches only: what one call costs the host when nothing else on the
    machine interrupts it (other work only adds)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_batch):
            fn()
        times.append((time.perf_counter() - t0) / per_batch * 1e6)
    torch.cuda.synchronize()
    return min(times)


def time_rng(reps):
    """uniform_rng (its key a tensor on the card, as the step passes it)
    and torch.rand at the main path's shape: device µs per kernel, host µs
    per call and back-to-back µs per call."""
    import torch
    from ust_run_tpu_torch.ops import rng
    n, size = RNG_SHAPE
    out = torch.empty((n, size, size), device="cuda")
    key = torch.from_numpy(rng.key_words(RNG_SEED)).cuda()
    kern = lambda: rng.uniform_fields(out, key)               # noqa: E731
    lib = lambda: torch.rand((n, size, size), device="cuda")  # noqa: E731
    fns = [("uniform_rng", kern), ("torch.rand", lib)]
    res = {}
    for name, fn in fns:
        dev, per_call = profiled_us(fn, reps)
        res[name] = dict(device_us=dev, kernels_per_call=per_call,
                         host_us_per_call=host_us(fn),
                         back_to_back_us=cuda_ms(fn, reps) * 1e3)
    return res


def fused_inputs(b, h, w, c, co, dtype, seed, w_scale=0.1):
    """Inputs of bn_relu_conv3x3 drawn on the CPU from a seed, on the
    card: y N(0,1) in `dtype`, inv U(0.5,1.5), shift 0.3*N, w w_scale*N
    (the draws of tests/test_fused_conv.py and the microbench)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((b, h, w, c), generator=g).to(dtype)
    inv = torch.rand((b, c), generator=g) + 0.5
    shift = torch.randn((b, c), generator=g) * 0.3
    wk = torch.randn((3, 3, c, co), generator=g) * w_scale
    return tuple(t.to("cuda") for t in (y, inv, shift, wk))


def ptxas_report(log):
    """One line per kernel of an nvcc build log written with -Xptxas -v:
    the entry's name, its registers, shared memory and spill bytes."""
    entries, name = {}, None
    with open(log) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                entries[name] = []
            elif name and ("Used" in line or "spill" in line
                           or "stack frame" in line):
                entries[name].append(line.split(":", 1)[-1].strip())
    short = {"moments_reduce": "moments_reduce_kernel",
             "conv_kernelILi64": "tma conv_kernel<BN=64>",
             "conv_kernelILi128": "tma conv_kernel<BN=128>",
             "bn_relu_conv3x3_kernelIf": "wmma-route kernel<float>",
             "bn_relu_conv3x3_kernelI13__nv_bf": "wmma-route kernel<bf16>",
             "sums_kernelI13__nv_bfloat16Li0": "sums<bf16, moments>",
             "sums_kernelI13__nv_bfloat16Li1": "sums<bf16, gradient>",
             "sums_kernelIfLi0": "sums<float, moments>",
             "sums_kernelIfLi1": "sums<float, gradient>",
             "finish_kernel": "finish",
             "apply_kernelI13": "apply<bf16>",
             "apply_kernelIf": "apply<float>",
             "input_grad_kernelI13": "input_grad<bf16>",
             "input_grad_kernelIf": "input_grad<float>"}
    out = []
    for name, info in entries.items():
        label = next((v for k, v in short.items() if k in name), name)
        out.append(f"{label}: " + "; ".join(info))
    if not out:
        fail(f"no ptxas report in {log}")
    return out


def phase_kernels(card):
    import torch
    from ust_run_tpu_torch.ops import rng

    seed = RNG_SEED
    for n, size in (RNG_SHAPE, (3, 37)):
        out = torch.empty((n, size, size), device="cuda")
        rng.uniform_fields(out, seed)
        torch.cuda.synchronize()
        plain = rng.uniform_batch_plain(n, size, seed, device="cuda")
        if not torch.equal(out, plain):
            fail(f"uniform_rng differs from its plain version at "
                 f"{(n, size, size)}: max |d| "
                 f"{(out - plain).abs().max().item()}")
    n, size = RNG_SHAPE
    out = torch.empty((n, size, size), device="cuda")
    rng.uniform_fields(out, seed)
    plain = rng.uniform_batch_plain(n, size, seed, device="cuda")
    max_err = (out - plain).abs().max().item()
    u = out.double()
    lo, hi = u.min().item(), u.max().item()
    mean, std = u.mean().item(), u.std().item()
    if not (lo >= 0.0 and hi < 1.0 and abs(mean - 0.5) < 0.01
            and abs(std - 12 ** -0.5) < 0.01):
        fail(f"uniform_rng statistics: min {lo} max {hi} mean {mean} "
             f"std {std}")
    if (u[0] - u[1]).abs().max().item() <= 0.1:
        fail("uniform_rng fields 0 and 1 do not differ")

    plain_ms = cuda_ms(lambda: rng.uniform_batch_plain(n, size, seed,
                                                       device="cuda"), 10)
    nbytes = n * size * size * 4
    quads = n * ((size * size + 3) // 4)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = quads * PHILOX_OPS_PER_QUAD / H100_NONTENSOR_OPS_PER_S * 1e3
    entry = dict(name="uniform_rng", route="cuda",
                 source="ust_run_tpu_torch/csrc/uniform_rng.cu",
                 replaces="ust_run_tpu/ops/pallas_rng.py:22",
                 launches=None, max_abs_err=max_err, ms=None,
                 plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 library_ms=None)
    print(f"[kernels] uniform_rng bit-equal to plain at (16,256,256) and "
          f"(3,37,37); min {lo:.3g} max {hi:.9f} mean {mean:.5f} "
          f"std {std:.5f}; plain {plain_ms:.3f} ms (timed on the device "
          f"after the last phase) | {card}", flush=True)
    return [entry]


def phase_rng_timing(card, entry):
    """uniform_rng's and torch.rand's device time per kernel
    (torch.profiler) apart from the host's cost per call, into `entry`.
    It runs after every other phase, so that no phase timed before it
    runs in a process that torch.profiler has traced."""
    t = time_rng(200)
    kern, lib = t["uniform_rng"], t["torch.rand"]
    if round(kern["kernels_per_call"]) != 1:  # the profiler may drop one
        fail(f"uniform_fields launched {kern['kernels_per_call']} kernels "
             "per call")
    entry.update(ms=kern["device_us"] / 1e3,
                 library_ms=lib["device_us"] / 1e3,
                 host_us_per_call=kern["host_us_per_call"],
                 library_host_us_per_call=lib["host_us_per_call"],
                 back_to_back_us=kern["back_to_back_us"],
                 library_back_to_back_us=lib["back_to_back_us"],
                 timing="ms, library_ms: device time per kernel "
                        "(torch.profiler, 200 launches); host_us_per_call: "
                        "least over 21 batches of 50 calls, host clock; "
                        "back_to_back_us: 200 calls between CUDA events")
    print(f"[rng timing] uniform_rng device {kern['device_us']:.2f} us/kernel "
          f"(bound {entry['bound_ms'] * 1e3:.2f} us, {entry['bound_by']}), "
          f"host {kern['host_us_per_call']:.2f} us/call "
          f"({kern['back_to_back_us']:.2f} back to back); torch.rand device "
          f"{lib['device_us']:.2f} us, host {lib['host_us_per_call']:.2f} "
          f"us/call ({lib['back_to_back_us']:.2f}) | {card}", flush=True)


def check_fused(args, label):
    """bn_relu_conv3x3 against its plain version on the same inputs, with
    the tolerances of the module docstring. Returns a dict: max |out -
    plain| (`err`), the outputs more than one bf16 ulp off (`past_ulp`, 0
    in f32) and the largest such |d| over max |plain| (`worst`), the
    moments' largest |d| over their largest magnitude (`m_err`), the
    library's plan (`geom`: route, tile rows, columns and channels, K
    chunk), its route's name (`route`) and a summary (`tile`: rows x
    columns x channels per tile, K chunks); where that route's tiles
    divide the image, what the moments would lose if the tile reduce
    dropped one tile, for the tile that loses least: its largest loss over
    the moment's largest magnitude (`drop`) and over the moment bar
    (`drop_bar`, which must exceed 1)."""
    import torch
    from ust_run_tpu_torch.ops import fused_conv as fc
    out, m1, m2 = fc.bn_relu_conv3x3(*args)
    torch.cuda.synchronize()
    p_out, p1, p2 = fc.bn_relu_conv3x3_plain(*args)
    o, p = out.float(), p_out.float()
    d = (o - p).abs()
    top = p.abs().max()
    if out.dtype == torch.float32:
        bad = d > 1e-4 + 1e-4 * p.abs()
    else:
        bad = d > torch.finfo(torch.bfloat16).eps * p.abs() + 1e-5 * top
    if bool(bad.any()):
        fail(f"bn_relu_conv3x3 {label}: {int(bad.sum())} of {d.numel()} "
             f"outputs off the plain version (max |d| {d.max().item()}, "
             f"max |plain| {top.item()})")
    b, h, w, co = p.shape
    c = args[0].shape[-1]
    geom = fc.library_plan(out.dtype, c, co, h, w)
    th, tw = geom.tile_h, geom.tile_w
    tiled = h % th == 0 and w % tw == 0
    res = dict(err=d.max().item(), past_ulp=0, worst=0.0, m_err=0.0,
               drop=None, drop_bar=None, geom=geom,
               route=fc.ROUTES[geom.route],
               tile=f"{th}x{tw}x{geom.tile_n}, {-(-c // geom.tile_k)} K "
                    f"chunks of {geom.tile_k}")
    drop, drop_bar = [], []
    for name, m, pm, f in (("m1", m1, p1, lambda x: x),
                           ("m2", m2, p2, torch.square)):
        scale = pm.abs().max().item()
        bar = MOMENT_RTOL * pm.abs() + MOMENT_RTOL * scale
        dm = (m - pm).abs()
        if bool((dm > bar).any()):
            fail(f"bn_relu_conv3x3 {label}: {name} max |d| "
                 f"{dm.max().item()}, {dm.max().item() / scale:.2e} of its "
                 f"largest magnitude")
        res["m_err"] = max(res["m_err"], dm.max().item() / scale)
        if tiled:
            # each tile's share of the moment, per (sample, tile, channel)
            lost = f(p).reshape(b, h // th, th, w // tw, tw, co) \
                .sum(dim=(2, 4)).abs() / (h * w)
            drop.append(lost.amax(dim=(0, 3)) / scale)
            drop_bar.append((lost / bar[:, None, None, :]).amax(dim=(0, 3)))
    if tiled:
        # a dropped tile loses its share of both moments
        res["drop"] = torch.maximum(*drop).min().item()
        res["drop_bar"] = torch.maximum(*drop_bar).min().item()
        if res["drop_bar"] <= 1.0:
            fail(f"bn_relu_conv3x3 {label}: the moment bar cannot see a "
                 f"tile dropped from the reduce ({res['drop_bar']:.3g} of "
                 f"the bar)")
    if out.dtype == torch.bfloat16:
        past_ulp = d > torch.finfo(torch.bfloat16).eps * p.abs()
        res["past_ulp"] = int(past_ulp.sum())
        res["worst"] = d[past_ulp].max().item() / top.item() \
            if past_ulp.any() else 0.0
    return res


def phase_fused_conv(card):
    """bn_relu_conv3x3: correctness against the plain version, then its
    path (the microbench of tools/bench_fused_conv.py) with counted
    launches."""
    import torch
    from ust_run_tpu_torch.ops import fused_conv as fc

    m_err, routes = 0.0, []
    fc.route_launches[:] = [0, 0]
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FUSED_TEST_SHAPES + FUSED_EDGE_SHAPES:
            res = check_fused(fused_inputs(*shape, dtype, seed=0),
                              f"{tuple(shape)} {dtype}")
            m_err = max(m_err, res["m_err"])
            routes.append(f"{tuple(shape)} {str(dtype)[6:]}: "
                          f"{res['route']} {res['tile']}")
            if dtype == torch.bfloat16 and shape == FUSED_EDGE_SHAPES[0]:
                # the TMA route's masks: N tile 128 with a partial second
                # N tile, several K chunks with a partial last one
                g = res["geom"]
                c, co = shape[3:]
                if (g.route, g.tile_n) != (1, 128) or co % g.tile_n == 0 \
                        or c <= g.tile_k or c % g.tile_k == 0:
                    fail(f"{shape} does not meet the TMA route's partial "
                         f"N tile and K chunk: {g}")
        ones = (torch.ones((1, 16, 16, 8), dtype=dtype, device="cuda"),
                torch.ones((1, 8), device="cuda"),
                torch.zeros((1, 8), device="cuda"),
                torch.ones((3, 3, 8, 8), device="cuda"))
        out = fc.bn_relu_conv3x3(*ones)[0].float()
        if (out[0, 0, 0, 0].item(), out[0, 0, 5, 0].item(),
                out[0, 5, 5, 0].item()) != (32.0, 48.0, 72.0) \
                or not torch.equal(out, fc.bn_relu_conv3x3_plain(*ones)[0]
                                   .float()):
            fail(f"bn_relu_conv3x3 edge case ({dtype}): corner "
                 f"{out[0, 0, 0, 0].item()} edge {out[0, 0, 5, 0].item()} "
                 f"interior {out[0, 5, 5, 0].item()}, want 32/48/72")
    print(f"[kernels] bn_relu_conv3x3 within tolerance of its plain version "
          f"at {len(FUSED_TEST_SHAPES) + len(FUSED_EDGE_SHAPES)} shapes x "
          f"f32/bf16 (moments "
          f"within {m_err:.1e} of their largest magnitude) and exact on "
          f"the all-ones edge case (4C/6C/9C); routes "
          + "; ".join(routes) + f"; launches per route "
          f"{dict(zip(fc.ROUTES, fc.route_launches))} | {card}", flush=True)
    check_routes = dict(zip(fc.ROUTES, fc.route_launches))
    if 0 in fc.route_launches:
        fail(f"a route of bn_relu_conv3x3 never ran: {check_routes}")

    inputs = [(label, fused_inputs(b, h, w, c, co, torch.bfloat16, seed=i,
                                   w_scale=0.05))
              for i, (label, b, h, w, c, co) in enumerate(FUSED_SHAPES)]
    checks = [check_fused(args, label) for label, args in inputs]
    max_err = max(c["err"] for c in checks)
    n_out = [a[0].numel() // a[0].shape[-1] * a[3].shape[-1]
             for _, a in inputs]
    print("[kernels] bn_relu_conv3x3 bf16 at the microbench shapes: max "
          "|out - plain| " + ", ".join(f"{c['err']:.4g}" for c in checks)
          + "; outputs beyond one bf16 ulp " + ", ".join(
              f"{c['past_ulp']} of {n}" for c, n in zip(checks, n_out))
          + ", the worst at " + ", ".join(f"{c['worst']:.2e}"
                                          for c in checks)
          + " of max |plain| (near-cancelling sums); moments within "
          + ", ".join(f"{c['m_err']:.1e}" for c in checks)
          + " of their largest magnitude, where one tile dropped from the "
          "reduce would read at least "
          + ", ".join(f"{c['drop']:.1e} ({c['drop_bar']:.0f}x the bar)"
                      for c in checks) + " at the route's tiles ("
          + ", ".join(f"{c['route']} {c['tile']}" for c in checks)
          + f") | {card}", flush=True)
    fc.launches = 0
    fc.route_launches[:] = [0, 0]
    rows = []
    for label, args in inputs:
        y, inv, shift, wk = args
        b, h, w, c = y.shape
        co = wk.shape[-1]
        ms = cuda_ms(lambda: fc.bn_relu_conv3x3(*args), 20)
        plain_ms = cuda_ms(lambda: fc.bn_relu_conv3x3_plain(*args), 3)
        chain_ms = cuda_ms(lambda: fc.reference_chain(*args), 20)
        nbytes = (y.numel() + b * h * w * co) * 2 \
            + (wk.numel() + inv.numel() + shift.numel() + 2 * b * co) * 4
        flops = 2 * b * h * w * 9 * c * co
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = flops / H100_BF16_FLOPS * 1e3
        rows.append(dict(shape=label, B=b, H=h, W=w, C=c, Co=co,
                         route=fc.ROUTES[fc.library_plan(
                             y.dtype, c, co, h, w).route], ms=ms,
                         plain_ms=plain_ms, library_ms=chain_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations",
                         tflops=flops / ms / 1e9, gbps=nbytes / ms / 1e6))
        r = rows[-1]
        print(f"[kernels] bn_relu_conv3x3 {label} {b}x{h}x{w}x{c}->{co} "
              f"bf16 ({r['route']}): {ms:.3f} ms ({r['tflops']:.1f} TFLOP/s, "
              f"{r['gbps']:.0f} GB/s), bound {r['bound_ms'] * 1e3:.1f} us "
              f"({r['bound_by']}, {r['bound_ms'] / ms:.1%} of it), plain "
              f"{plain_ms:.3f} ms, reference_chain {chain_ms:.3f} ms | "
              f"{card}", flush=True)
    launches = fc.launches
    if launches == 0:
        fail("bn_relu_conv3x3 was not launched in its microbench")
    route_launches = dict(zip(fc.ROUTES, fc.route_launches))
    top = rows[0]
    return dict(name="bn_relu_conv3x3", route="cuda",
                source="ust_run_tpu_torch/csrc/fused_conv.cu",
                replaces="ust_run_tpu/ops/fused_conv.py:53",
                launches=launches, route_launches=route_launches,
                check_route_launches=check_routes,
                max_abs_err=max_err, ms=top["ms"],
                plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"],
                library="reference_chain: BN+ReLU pass, cuDNN bf16 conv, "
                        "moment passes",
                path="microbench at the shapes of tools/bench_fused_conv.py"
                     " (the JAX model never calls the kernel)",
                shapes=rows)


def gbn_operands(n, c, h, w, dtype, sizes, seed=0):
    """The passes' operands on the card, drawn on the CPU from `seed`
    (tests/test_torch_grouped_bn.py's draws): x, dy channels_last; (g, c)
    inv, shift; (n, c) ds1, ds2; the groups' index."""
    import numpy as np
    import torch
    from ust_run_tpu_torch.ops import grouped_bn as gbn
    g = torch.Generator().manual_seed(seed)
    cl = dict(memory_format=torch.channels_last)
    x = (torch.randn((n, c, h, w), generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn((n, c, h, w), generator=g).to(dtype)
    k = len(sizes)
    inv = torch.rand((k, c), generator=g) + 0.5
    shift = torch.randn((k, c), generator=g) * 0.3 + 0.5
    ds1 = torch.randn((n, c), generator=g) * 1e-3
    ds2 = torch.randn((n, c), generator=g) * 1e-3
    seg = np.repeat(np.arange(k), sizes)
    off = np.concatenate([[0], np.cumsum(sizes)])
    groups = gbn.Groups(torch.as_tensor(seg, dtype=torch.int32).cuda(),
                        torch.as_tensor(off, dtype=torch.int32).cuda())
    return (x.cuda().contiguous(**cl), dy.cuda().contiguous(**cl),
            inv.cuda(), shift.cuda(), ds1.cuda(), ds2.cuda(), groups)


def gbn_reference_chain(x, weight, bias, seg, avg, relu, eps=1e-5):
    """The operator chain the kernels replace, for timing: the port's
    GroupedBatchNorm train forward before the kernels (float32 moments
    of a float32 copy, the group arithmetic on the (n,) int64 groups
    `seg` and the (g, n) averaging matrix `avg`, the affine in x's dtype
    in two passes), then the ReLU; autograd runs its backward."""
    import torch
    m1 = torch.mean(x, dim=(2, 3), dtype=torch.float32)
    m2 = torch.mean(torch.square(x.float()), dim=(2, 3))
    mean, mean2 = avg @ m1, avg @ m2
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    inv = torch.rsqrt(var + eps) * weight
    inv_n, mean_n = inv[seg], mean[seg]
    shift = mean_n * inv_n - bias
    y = x * inv_n[:, :, None, None].to(x.dtype) \
        - shift[:, :, None, None].to(x.dtype)
    return torch.relu(y) if relu else y


def phase_grouped_bn(card):
    """GroupedBatchNorm's four kernels against their plain versions at the
    main path's shapes (tests/test_torch_grouped_bn.py's bars), then
    timed by CUDA events beside their byte bound, the plain version, and
    the whole layer's forward and backward (with the ReLU) against the
    operator chain it replaced; all device times of captured calls
    (`graph_ms`), as the step runs them."""
    import torch
    from ust_run_tpu_torch.models.layers import GroupedBatchNorm
    from ust_run_tpu_torch.ops import grouped_bn as gbn

    def close(got, want, tol, what):
        err = (got.float() - want.float()).abs()
        if not bool((err <= tol).all()):
            fail(f"grouped_bn {what}: {int((err > tol).sum())} values "
                 f"past the bar, max |d| {err.max().item():.3g}")

    f32_eps = torch.finfo(torch.float32).eps
    gbn.launches = 0
    rows = []
    for label, (n, c, h, w, dname, sizes) in GBN_SHAPES:
        dtype = getattr(torch, dname)
        x, dy, inv, shift, ds1, ds2, groups = gbn_operands(
            n, c, h, w, dtype, sizes)
        xf, seg = x.float(), groups.seg.long()
        ulp = torch.finfo(dtype).eps
        s1, s2 = gbn.moments(x)
        p1, p2 = gbn.moments_plain(x)
        close(s1, p1, 1e-5 * xf.abs().sum(dim=(2, 3)), f"{label} s1")
        close(s2, p2, 1e-5 * (xf * xf).sum(dim=(2, 3)), f"{label} s2")
        y = gbn.apply(x, inv, shift, groups, True)
        want = gbn.apply_plain(x, inv, shift, groups, True)
        close(y, want, ulp * want.float().abs() + 4 * f32_eps * (
            (xf * inv[seg][:, :, None, None]).abs()
            + shift[seg][:, :, None, None].abs()), f"{label} apply")
        a, b = gbn.grad_sums(dy, y, x, groups, True)
        pa, pb = gbn.grad_sums_plain(dy, y, x, groups, True)
        gm = gbn._masked(dy, y, True)
        close(a, pa, 1e-5 * torch.zeros_like(pa).index_add_(
            0, seg, gm.abs().sum((2, 3))), f"{label} grad sum a")
        close(b, pb, 1e-5 * torch.zeros_like(pb).index_add_(
            0, seg, (gm * xf).abs().sum((2, 3))), f"{label} grad sum b")
        dx = gbn.input_grad(dy, y, x, inv, groups, ds1, ds2, True)
        want = gbn.input_grad_plain(dy, y, x, inv, groups, ds1, ds2, True)
        close(dx, want, ulp * want.float().abs() + 4 * f32_eps * (
            (gm * inv[seg][:, :, None, None]).abs()
            + ds1[:, :, None, None].abs()
            + (2 * xf * ds2[:, :, None, None]).abs()), f"{label} dx")
        del xf, gm, want
        again = (gbn.moments(x), gbn.grad_sums(dy, y, x, groups, True))
        if not all(torch.equal(u, v) for u, v in
                   zip((*again[0], *again[1]), (s1, s2, a, b))):
            fail(f"grouped_bn {label}: two runs of the sums differ")

        e = x.element_size() * x.numel()
        passes = [
            ("moments", 1, lambda: gbn.moments(x),
             lambda: gbn.moments_plain(x)),
            ("apply", 2, lambda: gbn.apply(x, inv, shift, groups, True),
             lambda: gbn.apply_plain(x, inv, shift, groups, True)),
            ("grad_sums", 3, lambda: gbn.grad_sums(dy, y, x, groups, True),
             lambda: gbn.grad_sums_plain(dy, y, x, groups, True)),
            ("input_grad", 4, lambda: gbn.input_grad(
                dy, y, x, inv, groups, ds1, ds2, True),
             lambda: gbn.input_grad_plain(dy, y, x, inv, groups, ds1, ds2,
                                          True))]
        for name, tensors, kern, plain in passes:
            ms = graph_ms(kern, 20)
            bound_ms = tensors * e / H100_BYTES_PER_S * 1e3
            rows.append(dict(shape=label, pass_=name, n=n, c=c, h=h, w=w,
                             dtype=dname, ms=ms,
                             plain_ms=graph_ms(plain, 3), bound_ms=bound_ms,
                             bound_by="bytes", share=bound_ms / ms,
                             gbps=tensors * e / ms / 1e6))
            r = rows[-1]
            print(f"[kernels] grouped_bn {name} {label} {n}x{c}x{h}x{w} "
                  f"{r['dtype']}: {ms * 1e3:.1f} us ({r['gbps']:.0f} GB/s), "
                  f"bound {bound_ms * 1e3:.1f} us (bytes, {r['share']:.1%} "
                  f"of it), plain {r['plain_ms']:.3f} ms | {card}",
                  flush=True)

        # the layer, forward and backward with the ReLU, against the chain
        bn = GroupedBatchNorm(c).cuda()
        xg = x.detach().requires_grad_()

        def layer():
            out = bn(xg, group_sizes=sizes, relu=True)
            xg.grad = bn.weight.grad = bn.bias.grad = None
            out.backward(dy)

        avg = torch.zeros((len(sizes), n), device="cuda")
        avg[seg, torch.arange(n, device="cuda")] = 1.0 / torch.tensor(
            sizes, dtype=torch.float32, device="cuda")[seg]

        def chain():
            out = gbn_reference_chain(xg, bn.weight, bn.bias, seg, avg, True)
            xg.grad = bn.weight.grad = bn.bias.grad = None
            out.backward(dy)
        layer_ms, chain_ms = graph_ms(layer, 5), graph_ms(chain, 5)
        rows.append(dict(shape=label, pass_="layer fwd+bwd", n=n, c=c, h=h,
                         w=w, dtype=dname, ms=layer_ms,
                         library_ms=chain_ms,
                         bound_ms=10 * e / H100_BYTES_PER_S * 1e3,
                         bound_by="bytes"))
        print(f"[kernels] grouped_bn layer forward+backward with the ReLU "
              f"{label}: {layer_ms:.3f} ms on the device (bound "
              f"{rows[-1]['bound_ms']:.3f} ms: 10 accesses an element), the "
              f"replaced operator chain {chain_ms:.3f} ms | {card}",
              flush=True)
        del x, dy, y, dx, xg, bn
        free_card()
    if gbn.launches == 0:
        fail("grouped_bn's kernels were not launched")
    top = rows[0]
    return dict(name="grouped_bn", route="cuda",
                source="ust_run_tpu_torch/csrc/grouped_bn.cu",
                replaces=None, launches=gbn.launches, ms=top["ms"],
                plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by="bytes", library_ms=None, shapes=rows)


def card_vs_cpu(make, grad_keys):
    """A model from `make()` (weights drawn from seed 1) in train mode on
    the CPU and, with the same weights, on the card, channels_last: the
    forward of a 6x64^2x3 input in 3 BN groups and the gradients of a
    fixed random projection of it. Returns (max |forward difference|, max
    |CPU forward|, the largest max |d|/max |g| over `grad_keys`)."""
    import torch
    net_cpu = make().init_weights_(torch.Generator().manual_seed(1))
    net_gpu = make().to("cuda", memory_format=torch.channels_last)
    net_gpu.load_state_dict(net_cpu.state_dict())
    x = torch.rand((6, 64, 64, 3), generator=torch.Generator()
                   .manual_seed(2)) * 2 - 1
    r = torch.randn((6, 64, 64, 2), generator=torch.Generator()
                    .manual_seed(3))
    outs = []
    for net, dev in ((net_cpu, "cpu"), (net_gpu, "cuda")):
        net.train()
        y = net(x.to(dev), groups=3)
        (y * r.to(dev)).sum().backward()
        outs.append((y.detach().cpu(), {k: p.grad.cpu() for k, p in
                                        net.named_parameters()}))
    grad_err = max(((outs[1][1][k] - outs[0][1][k]).abs().max()
                    / outs[0][1][k].abs().max().clamp_min(1e-12)).item()
                   for k in grad_keys)
    return ((outs[0][0] - outs[1][0]).abs().max().item(),
            outs[0][0].abs().max().item(), grad_err)


def phase_reference(card):
    """The UNet's train forward + backward on the card against the CPU."""
    from ust_run_tpu_torch.models import UNet

    # the out conv's gradients sit behind no ReLU or max-pool decision, so
    # float32 rounding cannot flip them (deeper gradients can jump at a
    # ReLU input within rounding of 0; the CPU tests pin those)
    fwd_err, _, grad_err = card_vs_cpu(lambda: UNet(3, 2),
                                       ("outc.conv.weight", "outc.conv.bias"))
    if not (fwd_err < 1e-3 and grad_err < 1e-3):
        fail(f"card vs CPU UNet: forward {fwd_err}, grads {grad_err}")
    print(f"[reference] UNet (6x64^2x3, 3 BN groups, f32, TF32 off) card "
          f"vs CPU: forward max |d| {fwd_err:.2e}, out-conv gradients max "
          f"|d|/max|g| {grad_err:.2e} | {card}", flush=True)


def sgd_update(params, grads, bufs, lr, fused):
    """One update of the step's optimizer (make_optimizer: momentum 0.9,
    weight decay 1e-4) over copies of `params` from momentum `bufs` and
    gradients `grads`, the learning rate a 0-d tensor on their device as
    apply_update sets it. Returns (parameters, momentum) after it."""
    import torch
    from ust_run_tpu_torch.semisup.state import make_optimizer
    ps = [p.clone().requires_grad_() for p in params]
    opt = make_optimizer(ps, 0.03, fused=fused)
    for p, g, b in zip(ps, grads, bufs):
        p.grad = g.clone()
        opt.state[p]["momentum_buffer"] = b.clone()
    for group in opt.param_groups:
        group["lr"] = torch.tensor(lr, device=params[0].device)
    opt.step()
    return ([p.detach() for p in ps],
            [opt.state[p]["momentum_buffer"] for p in ps])


def ulp_error(got, want, scale):
    """max |got - want| in float32 ulp of `scale` (elementwise, the
    largest operand of the last operation that made `want`)."""
    import numpy as np
    d = np.abs(got.double().cpu().numpy() - want.double().numpy())
    ulp = np.spacing(np.abs(scale.numpy()).astype(np.float32))
    return float((d / ulp).max())


def phase_fused_sgd(card):
    """The card's fused SGD update (SGD(fused=True), the step's route on
    CUDA) against the CPU's unfused one, which the CPU tests hold to JAX:
    one update of the fundus UNet's 31.0M parameters from equal
    parameters, gradients, momentum and learning rate (float32), each
    result within SGD_ULP float32 ulp of the CPU's."""
    import numpy as np
    import torch
    from ust_run_tpu_torch.models import UNet
    from ust_run_tpu_torch.semisup.state import lr_at
    params = [p.detach() for p in
              UNet(3, 2).init_weights_(torch.Generator().manual_seed(0))
              .parameters()]
    r = np.random.RandomState(0)
    grads = [torch.from_numpy(r.normal(0, 1e-2, p.shape).astype(np.float32))
             for p in params]
    bufs = [torch.from_numpy(r.normal(0, 1e-2, p.shape).astype(np.float32))
            for p in params]
    lr = lr_at(1000, 0.03, 30000)
    want_p, want_b = sgd_update(params, grads, bufs, lr, fused=False)
    got_p, got_b = sgd_update([p.cuda() for p in params],
                              [g.cuda() for g in grads],
                              [b.cuda() for b in bufs], lr, fused=True)
    err_b = err_p = 0.0
    for p, g, b, wp, wb, gp, gb in zip(params, grads, bufs, want_p, want_b,
                                       got_p, got_b):
        # momentum = 0.9 m + (g + 1e-4 p); parameter = p - lr momentum
        err_b = max(err_b, ulp_error(gb, wb, torch.maximum(
            (0.9 * b).abs(), (g + 1e-4 * p).abs())))
        err_p = max(err_p, ulp_error(gp, wp, torch.maximum(
            p.abs(), (lr * wb).abs())))
    if max(err_b, err_p) > SGD_ULP:
        fail(f"fused SGD on the card against the CPU's: momentum "
             f"{err_b:.2f} ulp, parameters {err_p:.2f} ulp (bar {SGD_ULP})")
    print(f"[fused sgd] one SGD(fused=True) update on the card (momentum "
          f"0.9, weight decay 1e-4, lr {lr:.6g} a 0-d device tensor) of the "
          f"UNet's {sum(p.numel() for p in params) / 1e6:.1f}M float32 "
          f"parameters against the CPU's unfused update from equal "
          f"parameters, gradients and momentum: worst momentum "
          f"{err_b:.2f} ulp, worst parameter {err_p:.2f} ulp (bar "
          f"{SGD_ULP}) | {card}", flush=True)


def phase_main_path(card, work, profile_out=None):
    import torch
    from ust_run_tpu_torch.data.synthetic import generate
    from ust_run_tpu_torch.ops import augment, fused_conv, grouped_bn, rng
    from ust_run_tpu_torch.semisup import step

    root = generate("fundus", os.path.join(work, "fundus"), n_train=8,
                    n_test=N_TEST, size=256, seed=0)
    # the bar of tests/test_ops.py:221 through the kernel: no augmentation
    # branch may blank out a bright sample
    img = torch.full((8, 256, 256, 3), 200, dtype=torch.uint8, device="cuda")
    lab = torch.full((8, 256, 256, 1), 128, dtype=torch.uint8,
                     device="cuda")
    out, _ = augment.weak_augment_batch(
        img, lab, size=256, fillcolor=255,
        generator=torch.Generator(device="cuda").manual_seed(11),
        key=rng.draw_seed(torch.Generator().manual_seed(12)))
    black = (out < 1.0).float().mean(dim=(1, 2, 3)).max().item()
    if black >= 0.5:
        fail(f"weak augmentation blanked a sample ({black:.3f} black)")

    argv = train_argv("fundus", root, work, "smoke")
    trainer, cfg = make_trainer(argv)
    p = cfg.profile()
    width = trainer.state.student.inc.double_conv[0].out_channels
    deepest = trainer.state.student.down4.maxpool_conv[1] \
        .double_conv[3].out_channels
    if (p.patch_size, p.num_channels, cfg.label_bs, cfg.unlabel_bs,
            width, deepest) != (256, 3, 4, 4, 64, 1024):
        fail("main path is not the full-width fundus configuration")

    if trainer.unroll != 10:
        fail(f"main path runs {trainer.unroll} steps per call, not the "
             "default --unroll_steps 10")
    reset_launches()
    fused_conv.launches = 0
    # the warm-up call (3 steps) captures the step graph; the timed call
    # replays it 10 times
    metrics, dt, peak_gib = step_window(trainer, WARMUP_STEPS, TIMED_STEPS)
    launches = {"uniform_rng": rng_launches(),
                "bn_relu_conv3x3": fused_conv.launches,
                "grouped_bn": grouped_bn.launches}
    graphs = dict(step.graph_counts)
    if (graphs["captures"], graphs["replays"]) != (1, WARMUP_STEPS
                                                   + TIMED_STEPS - 1):
        fail(f"main path: {graphs} (one capture, a replay per other step "
             "expected)")

    steps = WARMUP_STEPS + TIMED_STEPS
    if len(metrics) != steps:
        fail(f"{len(metrics)} metric rows for {steps} steps")
    check_losses(metrics, "fundus")
    if launches["uniform_rng"] != steps:
        fail(f"uniform_rng launched {launches['uniform_rng']} times in "
             f"{steps} steps")
    if launches["grouped_bn"] == 0 or launches["grouped_bn"] % steps:
        fail(f"grouped_bn launched {launches['grouped_bn']} times in "
             f"{steps} steps (the same passes every step expected)")
    imgs = TIMED_STEPS * (cfg.label_bs + cfg.unlabel_bs)
    step_ms = dt / TIMED_STEPS * 1e3
    last = metrics[-1]
    print(f"[main path] fundus UNet 64->1024, 3x256^2, batch 4+4, bf16 "
          f"autocast, --unroll_steps 10: {WARMUP_STEPS}+{TIMED_STEPS} steps "
          f"(a call of {WARMUP_STEPS} capturing the step graph, then "
          f"{TIMED_STEPS} replays), {imgs / dt:.2f} img/s, {step_ms:.1f} "
          f"ms/step, peak {peak_gib:.2f} GiB; uniform_rng launches "
          f"{launches['uniform_rng']} (captured once, run by "
          f"{graphs['replays']} replays and the capturing call's eager "
          f"step), bn_relu_conv3x3 "
          f"{launches['bn_relu_conv3x3']} (not on the model's path), "
          f"grouped_bn {launches['grouped_bn']} "
          f"({launches['grouped_bn'] // steps} a step, replays' included); no "
          f"host-device sync in the timed steps; last loss "
          f"{float(last['loss']):.4f} sup {float(last['sup_loss']):.4f} | "
          f"{card}", flush=True)
    if profile_out:
        phase_profile(card, trainer, step_ms, profile_out)
        # the same profile of eager steps (--unroll_steps 1)
        eager, _ = make_trainer(train_argv("fundus", root, work, "eager",
                                           "--unroll_steps", "1"))
        _, dt_e, _ = step_window(eager, WARMUP_STEPS, TIMED_STEPS)
        phase_profile(card, eager, dt_e / TIMED_STEPS * 1e3,
                      os.path.splitext(profile_out)[0] + "_eager.json",
                      "profile eager")
        eager.close()
        del eager
        free_card()
    return launches, trainer, argv, imgs / dt


def snapshot_dir(cfg):
    """<model_root>/<dataset>/<save_name>, as the CLI lays it out."""
    path = os.path.join(cfg.model_root, cfg.dataset, cfg.save_name)
    os.makedirs(path, exist_ok=True)
    return path


def check_eval(res, label, n_part):
    """Finite metrics, dice in [0, 1], for every domain and overall."""
    import numpy as np
    for where, r in [("overall", res)] + [(f"domain{i + 1}", d) for i, d in
                                          enumerate(res["domains"])]:
        m = np.asarray(r["metrics"])
        if m.shape != (5, n_part) or not np.isfinite(m).all() \
                or not np.isfinite(r["loss"]) \
                or not ((m[0] >= 0) & (m[0] <= 1)).all():
            fail(f"{label} evaluation, {where}: loss {r['loss']}, "
                 f"dice/dc/jc/hd95/asd {m.tolist()}")


def phase_eval(card, trainer, argv):
    """Evaluation, checkpoint, --load round trip and the standalone
    evaluator on the main path's trainer."""
    import numpy as np
    import torch

    n_part = trainer.profile_.n_part
    n_img = sum(len(ld.ds) for ld in trainer.evaluator.loaders)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # untimed: the first pass meets the eval shapes' convolutions cold
    trainer.evaluator.evaluate(trainer.state.teacher, 1)
    res, secs = {}, {}
    for name, model in (("ema", trainer.state.teacher),
                        ("stu", trainer.state.student)):
        t0 = time.perf_counter()
        res[name] = trainer.evaluator.evaluate(model, 1, ema=name == "ema")
        secs[name] = time.perf_counter() - t0
        check_eval(res[name], f"fundus {name}", n_part)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ema, stu = res["ema"]["metrics"], res["stu"]["metrics"]
    print(f"[eval] fundus EMA and student over {n_img} test images "
          f"({len(trainer.evaluator.loaders)} domains, batch "
          f"{trainer.cfg.eval_batch}): {n_img / secs['ema']:.1f} and "
          f"{n_img / secs['stu']:.1f} img/s with boundary metrics, peak "
          f"{peak_gib:.2f} GiB; EMA dice {ema[0].round(4).tolist()} hd95 "
          f"{ema[3].round(2).tolist()}, student dice "
          f"{stu[0].round(4).tolist()} asd {stu[4].round(2).tolist()}; all "
          f"finite | {card}", flush=True)

    trainer.evaluate_and_checkpoint(0, trainer.iter_num)
    trainer.wait_for_checkpoint()
    snap = trainer.snapshot_path
    for f in ("checkpoint.pth", "unet_avg_dice_best_model.pth"):
        if not os.path.exists(os.path.join(snap, f)):
            fail(f"no {f} in {snap}")
    resumed, cfg = make_trainer(argv + ["--load"])
    b = resumed.state
    n_pairs = check_resumed(trainer, resumed)
    worst = 0.0
    for name, model in (("ema", b.teacher), ("stu", b.student)):
        again = resumed.evaluator.evaluate(model, 1, ema=name == "ema")
        worst = max(worst, float(np.abs(again["metrics"]
                                        - res[name]["metrics"]).max()),
                    abs(again["loss"] - res[name]["loss"]))
    if worst > 1e-6:
        fail(f"the resumed trainer's evaluation differs by {worst}")
    resumed.close()
    trainer.close()
    mib = os.path.getsize(os.path.join(snap, "checkpoint.pth")) / 2 ** 20
    print(f"[eval] checkpoint written ({mib:.0f} MiB) and resumed with "
          f"--load: {n_pairs} tensors equal, epoch {resumed.start_epoch}, "
          f"step "
          f"{b.step}; evaluation reproduced within {worst:.1e} | {card}",
          flush=True)

    loss, secs = run_test_entry(cfg)
    print(f"[eval] python -m ust_run_tpu_torch.test on the best model: "
          f"rc 0, overall loss {loss:.4f}, {secs:.1f} s in all | {card}",
          flush=True)


def check_resumed(trainer, resumed):
    """Fails unless the --load trainer `resumed` holds `trainer`'s saved
    state: both models' state_dicts, the queue, the SGD momentum, the
    threshold, the step and the next epoch. Returns the tensors
    compared."""
    import torch
    a, b = trainer.state, resumed.state
    pairs = [(f"student.{k}", v, b.student.state_dict()[k])
             for k, v in a.student.state_dict().items()]
    pairs += [(f"teacher.{k}", v, b.teacher.state_dict()[k])
              for k, v in a.teacher.state_dict().items()]
    pairs += [(f"queue.{k}", v, b.queue.fields()[k])
              for k, v in a.queue.fields().items()]
    pairs += [(f"momentum.{i}", st["momentum_buffer"],
               b.optimizer.state_dict()["state"][i]["momentum_buffer"])
              for i, st in a.optimizer.state_dict()["state"].items()]
    pairs += [("choice_th", a.choice_th, b.choice_th)]
    diff = [k for k, x, y in pairs if not torch.equal(x, y)]
    if diff or (resumed.start_epoch, b.step) != (1, a.step):
        fail(f"--load did not restore the state: {diff[:5]}, start epoch "
             f"{resumed.start_epoch}, step {b.step} vs {a.step}")
    return len(pairs)


def run_test_entry(cfg, extra=()):
    """`python -m ust_run_tpu_torch.test` on cfg's snapshot, in a fresh
    process on cfg's device (4 domains); fails unless it exits 0 with a
    finite overall loss. Returns (loss, seconds)."""
    import numpy as np
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ust_run_tpu_torch.test", "--dataset",
         cfg.dataset, "--model", cfg.model, "--data_root", cfg.data_root,
         "--model_root", cfg.model_root, "--save_name", cfg.save_name,
         "--domain_num", "4", "--device", cfg.device, *extra], cwd=HERE,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": HERE})
    overall = [ln for ln in proc.stdout.splitlines()
               if "epoch 1 : loss" in ln and "domain" not in ln]
    if proc.returncode != 0 or not overall:
        fail(f"python -m ust_run_tpu_torch.test: rc {proc.returncode}\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    loss = float(overall[-1].split("loss : ")[1].split()[0])
    if not np.isfinite(loss):
        fail(f"python -m ust_run_tpu_torch.test: loss {loss}")
    return loss, time.perf_counter() - t0


def phase_busi(card, work):
    """The softmax profile on the card: BUSI_STEPS steps at full width,
    then one evaluation of both models."""
    import torch
    from ust_run_tpu_torch.data.synthetic import generate

    root = generate("BUSI", os.path.join(work, "busi"), n_train=8,
                    n_test=2, size=256, seed=1)
    trainer, cfg = make_trainer(train_argv("BUSI", root, work, "busi"))
    p = cfg.profile()
    if (p.patch_size, p.num_channels, p.num_classes, p.multilabel,
            cfg.label_bs, cfg.unlabel_bs) != (256, 1, 2, False, 4, 4):
        fail("BUSI phase is not the full-width softmax configuration")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, metrics, peak_gib = steps_one_by_one(trainer, BUSI_STEPS)
    check_losses(metrics, "BUSI")
    res = {name: trainer.evaluator.evaluate(model, 1, ema=name == "ema")
           for name, model in (("ema", trainer.state.teacher),
                               ("stu", trainer.state.student))}
    for name, r in res.items():
        check_eval(r, f"BUSI {name}", 1)
    trainer.close()
    print(f"[busi] BUSI UNet 64->1024, 1x256^2, batch 4+4, softmax, bf16 "
          f"autocast: {BUSI_STEPS} steps at "
          + ", ".join(f"{t:.1f}" for t in times)
          + f" ms (first includes warm-up), peak {peak_gib:.2f} GiB, last "
          f"loss {float(metrics[-1]['loss']):.4f}; EMA dice "
          f"{res['ema']['metrics'][0][0]:.4f} hd95 "
          f"{res['ema']['metrics'][3][0]:.2f}, student dice "
          f"{res['stu']['metrics'][0][0]:.4f}; all finite | {card}",
          flush=True)


def train_argv(dataset, root, work, save_name, *extra):
    """The trainer's flags for a phase: lb_domain 1, 4 labelled images,
    full width, on the card."""
    return ["--dataset", dataset, "--data_root", root, "--lb_domain", "1",
            "--lb_num", "4", "--save_name", save_name, "--overwrite",
            "--model_root", os.path.join(work, "model"), "--device", "cuda",
            *extra]


def make_trainer(argv, mesh=None):
    from ust_run_tpu_torch.config import build_parser, config_from_args
    from ust_run_tpu_torch.engine.trainer import Trainer
    cfg = config_from_args(build_parser().parse_args(argv)).resolve()
    # no mesh argument for an --ab tree from before the data-parallel port
    kw = {} if mesh is None else {"mesh": mesh}
    return Trainer(cfg, snapshot_dir(cfg), **kw), cfg


def check_losses(metrics, label):
    import numpy as np
    for i, m in enumerate(metrics):
        for k in LOSSES:
            if not np.isfinite(float(m[k])):
                fail(f"{label} step {i + 1}: {k} = {m[k]}")


def free_card():
    """Drop what the last phase left, so that each phase's peak is its
    own."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


class LogRecords:
    """Collects the root logger's INFO records while in a `with`."""

    def __enter__(self):
        import logging
        self.messages = []
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = lambda r: self.messages.append(r.getMessage())
        root = logging.getLogger()
        self.level = root.level
        root.setLevel(logging.INFO)
        root.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging
        root = logging.getLogger()
        root.removeHandler(self.handler)
        root.setLevel(self.level)


def phase_zoo_reference(card):
    """DeepLabV2 (ResNet-101) train forward + backward on the card against
    the CPU, at the bar of phase_reference."""
    from ust_run_tpu_torch.models import DeepLabV2

    # phase_reference's bar of 1e-3, as a share of the largest magnitude:
    # at init, with BN scales of 1, each of the 33 residual blocks adds a
    # branch as large as its input, and a float32 rounding difference
    # grows along the depth (the CPU parity tests see 1.3e-4 of the
    # logits between the JAX package's own jitted and eager forwards at
    # ResNet-50); the head's gradients sit behind no ReLU decision of
    # their own
    fwd_abs, top, grad_err = card_vs_cpu(
        lambda: DeepLabV2("resnet101", 2),
        ("classifier.0.weight", "classifier.0.bias", "classifier.3.weight",
         "classifier.3.bias"))
    fwd_err = fwd_abs / top
    if not (fwd_err < 1e-3 and grad_err < 1e-3):
        fail(f"card vs CPU DeepLabV2-R101: forward max |d|/max|y| "
             f"{fwd_err} (max |y| {top}), head grads {grad_err}")
    print(f"[zoo reference] DeepLabV2-ResNet-101 (6x64^2x3, 3 BN groups, "
          f"f32, TF32 off) card vs CPU: forward max |d|/max|y| "
          f"{fwd_err:.2e} (max |y| {top:.3g}), head gradients max "
          f"|d|/max|g| {grad_err:.2e} | {card}", flush=True)


def seeded_backbone_file(path, layers, seed):
    """A torchvision-layout ImageNet file from a seeded port ResNet:
    kaiming-normal convolutions, BN affine and running statistics drawn
    too, an `fc` head and no num_batches_tracked (torchvision's files
    predate it). Returns its tensors."""
    import torch
    from ust_run_tpu_torch.models import ResNet
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in ResNet(layers).init_weights_(g).state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if v.dim() == 1 and k.endswith(("weight", "running_var")):
            v = torch.rand(v.shape, generator=g) + 0.5
        elif v.dim() == 1:
            v = torch.randn(v.shape, generator=g) * 0.1
        sd[k] = v
    sd["fc.weight"] = torch.randn((1000, 2048), generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)
    return sd


def phase_zoo_path(card, work, profile_out=None):
    """--model deeplabv2 (ResNet-101) at full width through the trainer:
    the ImageNet overlay, the timed steps, evaluation, checkpoint and
    resume, and the standalone evaluator with --save_img. Returns the RNG
    kernel's launches in the steps."""
    import torch

    pre = os.path.join(work, "pretrained")
    file_sd = seeded_backbone_file(os.path.join(pre, "resnet101.pth"),
                                   RESNET101, seed=7)
    argv = train_argv("fundus", os.path.join(work, "fundus"), work, "zoo",
                      "--model", "deeplabv2", "--pretrained_root", pre)
    with LogRecords() as log:
        trainer, cfg = make_trainer(argv)
    if not any(m.startswith("loaded ImageNet backbone weights from")
               for m in log.messages):
        fail(f"no overlay log line for {pre}/resnet101.pth: "
             f"{log.messages[-3:]}")
    st = trainer.state
    p = cfg.profile()
    if (type(st.student).__name__, st.student.backbone.layers,
            p.patch_size, p.num_channels, cfg.label_bs, cfg.unlabel_bs) \
            != ("DeepLabV2", RESNET101, 256, 3, 4, 4) \
            or any(c.in_channels != 2048 for c in st.student.classifier):
        fail("zoo path is not DeepLabV2-ResNet-101 on full-width fundus")
    for name, model in (("student", st.student), ("teacher", st.teacher)):
        bb = model.backbone.state_dict()
        bad = [k for k, v in file_sd.items() if not k.startswith("fc.")
               and not torch.equal(bb[k].cpu(), v)]
        if bad:
            fail(f"the {name}'s backbone differs from resnet101.pth at "
                 f"{bad[:3]}")
    # stage 4's output: 2048 channels at stride 8, in every forward
    shapes = []
    hooks = [m.backbone.layer4[-1].register_forward_hook(
        lambda mod, i, o: shapes.append(tuple(o.shape)))
        for m in (st.student, st.teacher)]

    reset_launches()
    metrics, dt, peak_gib = step_window(trainer, WARMUP_STEPS, TIMED_STEPS)
    launches = rng_launches()
    for h in hooks:
        h.remove()
    s8 = p.patch_size // 8
    if not shapes or any(s[1:] != (2048, s8, s8) for s in shapes):
        fail(f"stage 4 outputs {sorted(set(shapes))}, want 2048 channels at "
             f"{s8}x{s8}")
    steps = WARMUP_STEPS + TIMED_STEPS
    if len(metrics) != steps:
        fail(f"{len(metrics)} metric rows for {steps} zoo steps")
    check_losses(metrics, "deeplabv2")
    if launches != steps:
        fail(f"uniform_rng launched {launches} times in {steps} zoo steps")
    imgs = TIMED_STEPS * (cfg.label_bs + cfg.unlabel_bs)
    print(f"[zoo path] fundus DeepLabV2-ResNet-101 (OS8, stage 4 "
          f"{sorted(set(shapes))}), 3x256^2, batch 4+4, float32: "
          f"{WARMUP_STEPS}+{TIMED_STEPS} steps, {imgs / dt:.2f} img/s, "
          f"{dt / TIMED_STEPS * 1e3:.1f} ms/step, peak {peak_gib:.2f} GiB; "
          f"uniform_rng launches {launches}; no host-device sync in the "
          f"timed steps; overlay of resnet101.pth into both backbones; last "
          f"loss {float(metrics[-1]['loss']):.4f} | {card}", flush=True)
    if profile_out:
        phase_profile(card, trainer, dt / TIMED_STEPS * 1e3, profile_out,
                      "zoo profile")

    n_part = p.n_part
    t0 = time.perf_counter()
    res = {name: trainer.evaluator.evaluate(model, 1, ema=name == "ema")
           for name, model in (("ema", st.teacher), ("stu", st.student))}
    eval_s = time.perf_counter() - t0
    for name, r in res.items():
        check_eval(r, f"deeplabv2 {name}", n_part)
    trainer.evaluate_and_checkpoint(0, trainer.iter_num)
    trainer.wait_for_checkpoint()
    snap = trainer.snapshot_path
    best = os.path.join(snap, "deeplabv2_avg_dice_best_model.pth")
    if not os.path.exists(best):
        fail(f"no best model written (student dice "
             f"{res['stu']['metrics'][0].tolist()})")
    with LogRecords():
        resumed, _ = make_trainer(argv + ["--load"])
    n_pairs = check_resumed(trainer, resumed)
    resumed.close()
    trainer.close()
    ema, stu = res["ema"]["metrics"], res["stu"]["metrics"]
    print(f"[zoo path] evaluation of both models over "
          f"{sum(len(ld.ds) for ld in trainer.evaluator.loaders)} test "
          f"images in {eval_s:.1f} s: EMA dice {ema[0].round(4).tolist()}, "
          f"student dice {stu[0].round(4).tolist()}, all finite; checkpoint "
          f"({os.path.getsize(os.path.join(snap, 'checkpoint.pth')) / 2**20:.0f}"
          f" MiB) resumed with --load: {n_pairs} tensors equal | {card}",
          flush=True)
    del trainer, resumed, st
    free_card()

    loss, secs = run_test_entry(cfg, ["--save_img"])
    pngs = sorted(os.listdir(os.path.join(snap, "pred_images")))
    n_img = 4 * N_TEST
    if len(pngs) != n_img or not all(f.endswith(".png") for f in pngs):
        fail(f"--save_img wrote {len(pngs)} files for {n_img} test images")
    print(f"[zoo path] python -m ust_run_tpu_torch.test --model deeplabv2 "
          f"--save_img: rc 0, overall loss {loss:.4f}, {len(pngs)} overlay "
          f"PNGs, {secs:.1f} s in all | {card}", flush=True)
    return launches


def phase_zoo_short(card, work):
    """SHORT_STEPS steps of the other zoo models the trainer takes."""
    cases = [("deeplabv2_r50", "fundus", (3, 4, 6, 3)),
             ("unet2d", "fundus", None), ("unet2d", "BUSI", None)]
    for model, dataset, layers in cases:
        root = os.path.join(work, dataset.lower())
        with LogRecords():
            trainer, cfg = make_trainer(train_argv(
                dataset, root, work, f"{model}_{dataset}", "--model", model,
                "--pretrained_root", os.path.join(work, "no_pretrained")))
        net = trainer.state.student
        if type(net).__name__ != ("DeepLabV2" if layers else "Unet2D") \
                or (layers and net.backbone.layers != layers):
            fail(f"--model {model} built {type(net).__name__}")
        reset_launches()
        times, metrics, peak_gib = steps_one_by_one(trainer, SHORT_STEPS)
        check_losses(metrics, f"{model} {dataset}")
        if rng_launches() != SHORT_STEPS:
            fail(f"uniform_rng launched {rng_launches()} times in "
                 f"{SHORT_STEPS} {model} steps")
        trainer.close()
        print(f"[zoo short] {dataset} --model {model}, "
              f"{cfg.profile().num_channels}x256^2, batch 4+4, float32: "
              f"{SHORT_STEPS} steps at " + ", ".join(f"{t:.1f}" for t in times)
              + f" ms (first includes warm-up), peak {peak_gib:.2f} GiB, last "
              f"loss {float(metrics[-1]['loss']):.4f}, uniform_rng launches "
              f"{rng_launches()} | {card}", flush=True)
        del trainer, net
        free_card()


def phase_prostate_mnms(card, work):
    """The RNG kernel at the prostate and MNMS field shapes, then the UNet
    at full width on both profiles, MNMS through its own entry."""
    import logging

    import numpy as np
    import torch
    from ust_run_tpu_torch import train_mnms
    from ust_run_tpu_torch.data.synthetic import generate
    from ust_run_tpu_torch.ops import rng

    for n, size in ((16, 384), (16, 288)):
        out = torch.empty((n, size, size), device="cuda")
        rng.uniform_fields(out, RNG_SEED)
        plain = rng.uniform_batch_plain(n, size, RNG_SEED, device="cuda")
        if not torch.equal(out, plain):
            fail(f"uniform_rng differs from its plain version at "
                 f"{(n, size, size)}")

    root = generate("prostate", os.path.join(work, "prostate"), n_train=8,
                    n_test=2, size=384, seed=2)
    trainer, cfg = make_trainer(train_argv("prostate", root, work,
                                           "prostate"))
    p = cfg.profile()
    if (p.patch_size, p.num_channels, p.num_classes,
            type(trainer.state.student).__name__) != (384, 1, 2, "UNet"):
        fail("prostate phase is not the full-width UNet configuration")
    reset_launches()
    times, metrics, peak_gib = steps_one_by_one(trainer, SHORT_STEPS)
    check_losses(metrics, "prostate")
    if rng_launches() != SHORT_STEPS:
        fail(f"uniform_rng launched {rng_launches()} times in {SHORT_STEPS} "
             f"prostate steps")
    res = {name: trainer.evaluator.evaluate(model, 1, ema=name == "ema")
           for name, model in (("ema", trainer.state.teacher),
                               ("stu", trainer.state.student))}
    for name, r in res.items():
        check_eval(r, f"prostate {name}", 1)
    trainer.close()
    print(f"[prostate] prostate UNet 64->1024, 1x384^2, batch 4+4, bf16 "
          f"autocast, {cfg.domain_num} domains: {SHORT_STEPS} steps at "
          + ", ".join(f"{t:.1f}" for t in times)
          + f" ms (first includes warm-up), peak {peak_gib:.2f} GiB; EMA "
          f"dice {res['ema']['metrics'][0][0]:.4f}, student dice "
          f"{res['stu']['metrics'][0][0]:.4f}; all finite; uniform_rng "
          f"bit-equal at (16,384,384) and (16,288,288) | {card}", flush=True)
    del trainer
    free_card()

    root = generate("MNMS", os.path.join(work, "mnms"), n_train=8,
                    n_test=2, size=288, seed=3)
    log = logging.getLogger()
    handlers, level = list(log.handlers), log.level
    reset_launches()
    t0 = time.perf_counter()
    try:        # the entry logs to <snapshot>/log.txt and stdout
        trainer = train_mnms.main([
            "--data_root", root, "--lb_domain", "1", "--lb_num", "4",
            "--save_name", "mnms", "--overwrite", "--max_iterations",
            str(SHORT_STEPS), "--num_eval_iter", str(SHORT_STEPS),
            "--model_root", os.path.join(work, "model"), "--device",
            "cuda"])
    finally:
        for h in log.handlers[len(handlers):]:
            log.removeHandler(h)
            h.close()
        log.setLevel(level)
    secs = time.perf_counter() - t0
    cfg, p, snap = trainer.cfg, trainer.cfg.profile(), trainer.snapshot_path
    if (cfg.dataset, p.patch_size, p.num_channels, p.num_classes,
            trainer.state.step) != ("MNMS", 288, 1, 4, SHORT_STEPS):
        fail("train_mnms did not run the MNMS profile's steps")
    if rng_launches() != SHORT_STEPS:
        fail(f"uniform_rng launched {rng_launches()} times in {SHORT_STEPS} "
             f"MNMS steps")
    text = open(os.path.join(snap, "log.txt")).read()
    lines = [ln for ln in text.splitlines() if "iteration" in ln
             and "sup_loss" in ln]
    loss = float(lines[-1].split("loss : ")[1].split(",")[0]) \
        if lines else float("nan")
    finite = all(bool(torch.isfinite(v).all())
                 for v in trainer.state.student.state_dict().values()
                 if v.is_floating_point())
    if not (np.isfinite(loss) and finite and "test stu model" in text
            and os.path.exists(os.path.join(snap, "checkpoint.pth"))):
        fail(f"train_mnms: last loss {loss}, student finite {finite}, "
             f"evaluation and checkpoint in {snap}")
    res = trainer.evaluator.evaluate(trainer.state.teacher, 1)
    check_eval(res, "MNMS ema", 3)
    print(f"[mnms] python -m ust_run_tpu_torch.train_mnms, UNet 64->1024, "
          f"1x288^2, 4 classes, batch 4+4, bf16 autocast: {SHORT_STEPS} steps"
          f", the epoch-end evaluation and checkpoint in {secs:.1f} s, loss "
          f"{loss:.4f}, student finite; EMA dice lv/myo/rv "
          f"{res['metrics'][0].round(4).tolist()}, all finite | {card}",
          flush=True)
    del trainer
    free_card()


def state_tensors(state):
    """Everything a replica holds, by name: both models' state_dicts, the
    SGD momentum, the queue, the LQ carry and choice_th."""
    import dataclasses
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    out.update({f"momentum.{i}": s["momentum_buffer"] for i, s in
                state.optimizer.state_dict()["state"].items()})
    out.update({f"queue.{k}": v for k, v in state.queue.fields().items()})
    out.update({f"lq.{f.name}": getattr(state.lq, f.name)
                for f in dataclasses.fields(state.lq)})
    out["choice_th"] = state.choice_th
    return out


def update_share(got, ref, init, prefix):
    """||got - ref|| / ||ref - init|| over the float tensors under
    `prefix`: how far `got` lies from `ref` as a share of how far the steps
    moved `ref`."""
    import torch
    keys = [k for k in ref if k.startswith(prefix)
            and ref[k].is_floating_point()]
    d = moved = 0.0
    for k in keys:
        r = ref[k].double().cpu()
        start = init[k].double().cpu() if k in init else 0.0   # momentum: 0
        d += float((got[k].double().cpu() - r).square().sum())
        moved += float((r - start).square().sum())
    return math.sqrt(d / max(moved, 1e-300))


def mean_of_local_losses(world):
    """The control fault of phase 13 (b): what averaging the ranks' own
    losses (plain DDP) computes. Each rank's loss terms are those of its
    rows alone, divided by the ranks, so that the gradient sum averages
    the local gradients. Returns the fault, to put in the place of
    losses.ce_plus_dice."""
    from ust_run_tpu_torch.utils import losses
    port = losses.ce_plus_dice

    def fault(*args, mesh=None, rows=None, **kw):
        return port(*args, **kw) / world
    return fault


def planted(fault, world):
    """Put a control fault in place in this process; returns the undo.
    "local_losses" (phase 13 b): what averaging the ranks' own losses
    (plain DDP) computes, through `mean_of_local_losses`; "zero_halo"
    (phase 15 b): every slab's halo rows zeroed, as if each slab were the
    image's edge."""
    from ust_run_tpu_torch.parallel import spatial
    from ust_run_tpu_torch.utils import losses
    saved = [(losses, "ce_plus_dice", losses.ce_plus_dice),
             (spatial, "halo_rows", spatial.halo_rows)]
    if fault == "local_losses":
        losses.ce_plus_dice = mean_of_local_losses(world)
    elif fault == "zero_halo":
        import torch.nn.functional as F
        spatial.halo_rows = lambda x, mesh, top=1, bottom=1, fill="zeros", \
            bounds=None: F.pad(x, (0, 0, top, bottom))

    def undo():
        for obj, name, v in saved:
            setattr(obj, name, v)
    return undo


def dp_rank(rank, world, work, fundus_runs, zoo_argv, spatial=1,
            tag="dp"):
    """One rank of a Gloo group on cuda:0 (spawned), laid out as a
    (world // spatial) x spatial mesh: the fundus runs, each (name, argv,
    steps, planted) from the same seed (`planted`: a fault of `planted`,
    or None), then, with `zoo_argv`, DP_STEPS `deeplabv2_r50` steps and
    one sharded evaluation beside this rank's evaluation of every sample
    alone. Saves what it saw to `<work>/<tag>_ranks/rank<rank>.pt`; rank
    0 adds the fundus runs' states."""
    import torch
    from ust_run_tpu_torch import parallel
    from ust_run_tpu_torch.engine.evaluator import Evaluator

    mesh = parallel.init_distributed(
        backend="gloo", device="cuda:0", rank=rank, world_size=world,
        init_method="file://" + os.path.join(work, f"{tag}_store"),
        spatial=spatial)
    res = {}
    try:
        for name, argv, steps, fault in fundus_runs:
            undo = planted(fault, world)
            try:
                trainer, _ = make_trainer(argv, mesh)
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t0 = time.perf_counter()
                metrics = trainer.train_steps(steps)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                undo()
            st = state_tensors(trainer.state)
            res[name] = dict(
                metrics=metrics, launches=rng_launches(), secs=secs,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                replica_diff=mesh.max_replica_difference(list(st.values())))
            if rank == 0:
                res[name]["state"] = {k: v.detach().cpu()
                                      for k, v in st.items()}
            trainer.close()
            del trainer, st
            free_card()

        if zoo_argv is not None:
            with LogRecords():
                trainer, _ = make_trainer(zoo_argv, mesh)
            reset_launches()
            metrics = trainer.train_steps(DP_STEPS)
            launches = rng_launches()
            st = state_tensors(trainer.state)
            diff = mesh.max_replica_difference(list(st.values()))
            ev = trainer.evaluator
            with LogRecords():
                sharded = ev.evaluate(trainer.state.teacher, 1)
                alone = Evaluator(ev.hp, ev.loaders, ev.parts,
                                  ev.device).evaluate(trainer.state.teacher,
                                                      1)
            res["zoo"] = dict(metrics=metrics, launches=launches,
                              replica_diff=diff, sharded=sharded, alone=alone,
                              model=type(trainer.state.student).__name__,
                              layers=trainer.state.student.backbone.layers)
            trainer.close()
    finally:
        mesh.close()
    torch.save(res, os.path.join(work, f"{tag}_ranks", f"rank{rank}.pt"))


def run_dp_ranks(work, world, *args, spatial=1, tag="dp", timeout=600):
    """dp_rank on `world` spawned processes; fails on a rank's error or
    after `timeout` s, and kills what still runs. Returns their results."""
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    os.makedirs(os.path.join(work, f"{tag}_ranks"), exist_ok=True)
    ctx = mp.start_processes(dp_rank, args=(world, work) + args
                             + (spatial, tag),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                fail(f"the {tag} ranks took more than {timeout} s")
    except ProcessException as e:
        fail(f"a {tag} rank failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(os.path.join(work, f"{tag}_ranks", f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def world1_references(root, work):
    import torch
    """Phase 5's trainer at world 1, no process group: (its initial state,
    the metrics and state after DP_STEPS steps, the SGD momentum after one
    float32 step, i.e. the first step's gradient, and that step's peak
    GiB)."""
    plain, _ = make_trainer(train_argv("fundus", root, work, "dp_plain"))
    init = {k: v.detach().clone()
            for k, v in state_tensors(plain.state).items()}
    ref_metrics = plain.train_steps(DP_STEPS)
    ref = {k: v.detach().clone()
           for k, v in state_tensors(plain.state).items()}
    plain.close()
    del plain
    free_card()
    plain, _ = make_trainer(train_argv("fundus", root, work, "dp_f32",
                                       "--amp", "0"))
    torch.cuda.reset_peak_memory_stats()
    plain.train_steps(1)
    peak_f32 = torch.cuda.max_memory_allocated() / 2 ** 30
    ref_grad = {k: v.detach().clone()
                for k, v in state_tensors(plain.state).items()
                if k.startswith("momentum.")}
    plain.close()
    del plain
    free_card()
    return init, ref_metrics, ref, ref_grad, peak_f32


def first_losses_error(metrics, ref_metrics):
    """max relative |d| of the first step's losses against world 1's."""
    return max(abs(float(metrics[0][k]) - float(ref_metrics[0][k]))
               / max(abs(float(ref_metrics[0][k])), 1e-30) for k in LOSSES)


def nccl_world1(card, work, root, main_img_s, profile_out=None):
    """Phase 13 (a): one rank under NCCL at the default --unroll_steps 10,
    the step and its collectives captured as one CUDA graph and replayed,
    against the same steps as eager NCCL steps and against the graph path
    with no process group, bit for bit; with `profile_out`, the host's idle
    share of the NCCL step, on the graph and eager, each profiled in a
    fresh process (`--ab-run`). Returns (uniform_rng launches of the
    graph run, its config)."""
    from ust_run_tpu_torch import parallel
    plain_tr, plain = unroll_run(root, work, "dp_plain", [], *UNROLL_STEPS)
    plain_tr.close()
    del plain_tr
    free_card()
    mesh = parallel.init_distributed(
        backend="nccl", device="cuda:0", rank=0, world_size=1,
        init_method="file://" + os.path.join(work, "dp_store_a"))
    runs = {}
    try:
        for mode, extra in (("graph", []), ("eager", ["--unroll_steps",
                                                      "1"])):
            trainer, runs[mode] = unroll_run(root, work, f"dp_nccl_{mode}",
                                             extra, *UNROLL_STEPS, mesh=mesh)
            cfg = trainer.cfg
            trainer.close()
            del trainer
            free_card()
    finally:
        mesh.close()
    idle = {}
    if profile_out:     # in fresh processes, as --ab runs: more profiler
        # windows in this process can leave a later phase's trace short of
        # a kernel
        for mode, spec in (("graph", "nccl"), ("eager", "nccl-eager")):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--ab-run",
                 f"{HERE}@{spec}", "--profile",
                 f"{os.path.splitext(profile_out)[0]}_{spec}.json"],
                capture_output=True, text=True)
            if out.returncode:
                fail(f"(a) the profiled NCCL run ({spec}) exited "
                     f"{out.returncode}: {out.stdout[-1500:]} "
                     f"{out.stderr[-1500:]}")
            run = json.loads(out.stdout.strip().splitlines()[-1])
            idle[mode] = 1.0 - (run["profile"]["device_kernel_ms_per_step"]
                                / run["ms_step"])
    steps = sum(UNROLL_STEPS)
    graph, eager = runs["graph"], runs["eager"]
    for label, other in (("eager NCCL steps", eager),
                         ("the graph path with no process group", plain)):
        diff_rows, diff_state = rows_and_state_diff(graph, other)
        if diff_rows or diff_state:
            fail(f"(a) world 1 under NCCL on the graph against {label}: "
                 f"rows {diff_rows[:5]}, state {diff_state[:5]} differ")
    check_losses(graph[0], "world-1 NCCL graph")
    counts = (graph[4], eager[4], graph[5]["captures"], graph[5]["replays"],
              eager[5]["replays"])
    if counts != (steps, steps, 1, steps - 1, 0):
        fail(f"(a) world-1 NCCL uniform_rng runs (graph, eager), captures, "
             f"replays (graph, eager): {counts} in {steps} steps")
    launches_a = graph[4]
    img = cfg.label_bs + cfg.unlabel_bs
    print(f"[data parallel] (a) world 1 under NCCL, fundus UNet 64->1024, "
          f"3x256^2, batch 4+4, bf16 autocast, {steps} steps at "
          f"--unroll_steps 10 (1 capture of the step with its NCCL "
          f"collectives, {graph[5]['replays']} replays): every metric row "
          f"and {len(list(state_leaves(graph[1])))} state tensors bit-equal "
          f"to {steps} eager NCCL steps and to the graph path with no "
          f"process group; {UNROLL_STEPS[1]} replays under the sync debug "
          f"mode at {img / graph[2] * 1e3:.2f} img/s ({graph[2]:.1f} "
          f"ms/step; eager NCCL {img / eager[2] * 1e3:.2f}, no process group "
          f"{img / plain[2] * 1e3:.2f}; phase 5: {main_img_s:.2f}), peak "
          f"{graph[3]:.2f} GiB; uniform_rng runs {launches_a} / {eager[4]}"
          + ("" if not idle else
             f"; host idle share of the step {idle['eager']:.3f} eager, "
             f"{idle['graph']:.3f} on the graph")
          + f" | {card}", flush=True)
    return launches_a, cfg


def phase_data_parallel(card, work, main_img_s, profile_out=None):
    """The trainer on a data-parallel mesh (ust_run_tpu_torch.parallel),
    full-width fundus as in phase 5: (a) world 1 under NCCL, the K-step
    call's CUDA graph against eager NCCL steps and the graph path with no
    process group (`nccl_world1`), (b) two Gloo ranks sharing cuda:0
    against world 1, (c) two Gloo ranks on deeplabv2_r50 and a sharded
    evaluation. Returns the RNG kernel's launches in each run."""
    import numpy as np
    import torch

    root = os.path.join(work, "fundus")
    init, ref_metrics, ref, ref_grad, _ = world1_references(root, work)

    launches_a, cfg = nccl_world1(card, work, root, main_img_s, profile_out)

    # (b) and (c): two Gloo ranks sharing cuda:0, each fundus run from the
    # same seed; the planted ones average the ranks' local losses
    runs = [(name, train_argv("fundus", root, work, f"dp_{name}", "--device",
                              "cuda:0", *extra), steps, planted)
            for name, extra, steps, planted in (
                ("bf16", (), DP_STEPS, None),
                ("bf16_planted", (), DP_STEPS, "local_losses"),
                ("f32", ("--amp", "0"), 1, None),
                ("f32_planted", ("--amp", "0"), 1, "local_losses"))]
    t0 = time.perf_counter()
    res = run_dp_ranks(
        work, 2, runs,
        train_argv("fundus", root, work, "dp_zoo", "--device", "cuda:0",
                   "--model", "deeplabv2_r50", "--pretrained_root",
                   os.path.join(work, "no_pretrained")))
    wall = time.perf_counter() - t0
    for r, out in enumerate(res):
        for run, steps in [(name, steps) for name, _, steps, _ in runs] \
                + [("zoo", DP_STEPS)]:
            o = out[run]
            check_losses(o["metrics"], f"rank {r} {run}")
            if o["replica_diff"] != 0.0:
                fail(f"{run}: rank {r} differs from rank 0 by "
                     f"{o['replica_diff']} after {steps} steps")
            if o["launches"] != steps:
                fail(f"{run}: uniform_rng launched {o['launches']} times in "
                     f"{steps} steps on rank {r}")
    b = res[0]["bf16"]
    loss_err = first_losses_error(b["metrics"], ref_metrics)
    shares = {p: update_share(b["state"], ref, init, p)
              for p in ("student.", "teacher.", "momentum.")}
    planted = {p: update_share(res[0]["bf16_planted"]["state"], ref, init, p)
               for p in shares}
    exact = [k for k in ("queue.valid", "lq.img", "lq.valid", "choice_th")
             if not torch.equal(b["state"][k], ref[k].cpu())]
    grad = {run: update_share(res[0][run]["state"], ref_grad, {},
                              "momentum.") for run in ("f32", "f32_planted")}
    print(f"[data parallel] (b) 2 Gloo ranks sharing cuda:0, same "
          f"configuration, {DP_STEPS} steps: replicas bit-equal (max |d| "
          f"0), uniform_rng launches {[o['bf16']['launches'] for o in res]}"
          f"; vs world 1: first-step losses max rel |d| {loss_err:.2e}, after "
          f"{DP_STEPS} steps ||d||/||update|| student {shares['student.']:.2e}"
          f" teacher {shares['teacher.']:.2e} momentum "
          f"{shares['momentum.']:.2e} (bar {DP_UPDATE_SHARE}; with the mean "
          f"of the ranks' local losses planted: {planted['student.']:.2e}, "
          f"{planted['teacher.']:.2e}, {planted['momentum.']:.2e}), queue/LQ "
          f"image/choice_th {'equal' if not exact else exact}; two processes "
          f"on one card: "
          f"{DP_STEPS * (cfg.label_bs + cfg.unlabel_bs) / b['secs']:.2f} "
          f"img/s (not a scaling figure) | {card}", flush=True)
    print(f"[data parallel] (b) float32 (--amp 0), 1 step, the gradient vs "
          f"world 1's, ||d||/||g||: {grad['f32']:.2e}; with the mean of the "
          f"ranks' local losses planted {grad['f32_planted']:.2e} (bar "
          f"{DP_GRAD_SHARE}: the port within, the planted fault beyond) | "
          f"{card}", flush=True)
    if loss_err > DP_LOSS_RTOL or max(shares.values()) > DP_UPDATE_SHARE \
            or exact:
        fail(f"2 ranks vs world 1: losses {loss_err}, shares {shares}, "
             f"unequal {exact}")
    if grad["f32"] > DP_GRAD_SHARE or grad["f32_planted"] <= DP_GRAD_SHARE:
        fail(f"float32 gradient vs world 1: {grad} against {DP_GRAD_SHARE}")

    z = [out["zoo"] for out in res]
    worst = max(max(float(np.abs(o["sharded"]["metrics"]
                                 - o["alone"]["metrics"]).max()),
                    abs(o["sharded"]["loss"] - o["alone"]["loss"]))
                for o in z)
    if (z[0]["model"], z[0]["layers"]) != ("DeepLabV2", (3, 4, 6, 3)) \
            or worst > 1e-6:
        fail(f"(c) {z[0]['model']} {z[0]['layers']}: sharded evaluation "
             f"vs one rank alone max |d| {worst}")
    check_eval(z[0]["sharded"], "deeplabv2_r50 sharded", cfg.profile().n_part)
    print(f"[data parallel] (c) 2 Gloo ranks, deeplabv2_r50, float32, "
          f"{DP_STEPS} steps: replicas bit-equal, uniform_rng launches "
          f"{[o['launches'] for o in z]}; the sharded evaluation (EMA dice "
          f"{z[0]['sharded']['metrics'][0].round(4).tolist()}) equals each "
          f"rank's evaluation of every sample alone within {worst:.1e}; "
          f"(b)+(c) {wall:.1f} s wall | {card}", flush=True)
    gloo_img_s = DP_STEPS * (cfg.label_bs + cfg.unlabel_bs) / b["secs"]
    return gloo_img_s, {"world1_nccl": launches_a,
            "gloo_fundus": [o["bf16"]["launches"] for o in res],
            "gloo_deeplabv2_r50": [o["launches"] for o in z]}


def phase_spatial(card, work, gloo_img_s):
    """The trainer on a mesh with a space axis (parallel/spatial.py: row
    slabs, halo rows), full-width fundus as in phase 5, Gloo ranks sharing
    cuda:0: (a) 1 x 2 (data 1 x space 2), bf16, DP_STEPS steps against
    world 1, and one float32 step whose gradient must lie within
    DP_GRAD_SHARE of world 1's; (b) the same runs with the halo rows
    zeroed, which must miss one of those bars; (c) 2 x 2 on four ranks,
    float32, one step, the gradient against world 1's. Returns the RNG
    kernel's launches in each run."""
    root = os.path.join(work, "fundus")
    init, ref_metrics, ref, ref_grad, peak_f32 = world1_references(root,
                                                                   work)
    bf16 = train_argv("fundus", root, work, "sp_bf16", "--device", "cuda:0")
    f32 = train_argv("fundus", root, work, "sp_f32", "--device", "cuda:0",
                     "--amp", "0")
    runs = [("bf16", bf16, DP_STEPS, None),
            ("zero_halo", bf16, DP_STEPS, "zero_halo"),
            ("f32", f32, 1, None), ("f32_zero_halo", f32, 1, "zero_halo")]
    t0 = time.perf_counter()
    res = run_dp_ranks(work, 2, runs, None, spatial=2, tag="sp12")
    wall_a = time.perf_counter() - t0
    for r, out in enumerate(res):
        for run, _, steps, _ in runs:
            o = out[run]
            check_losses(o["metrics"], f"1x2 rank {r} {run}")
            if o["replica_diff"] != 0.0:
                fail(f"1x2 {run}: rank {r} differs from rank 0 by "
                     f"{o['replica_diff']} after {steps} steps")
            if o["launches"] != steps:
                fail(f"1x2 {run}: uniform_rng launched {o['launches']} "
                     f"times in {steps} steps on rank {r}")
    batch = 8                                       # 4 + 4, phase 5's
    b, z = res[0]["bf16"], res[0]["zero_halo"]
    loss_err, zero_err = (first_losses_error(o["metrics"], ref_metrics)
                          for o in (b, z))
    shares, zero = ({p: update_share(o["state"], ref, init, p)
                     for p in ("student.", "teacher.", "momentum.")}
                    for o in (b, z))
    grad, zero_grad = (update_share(res[0][run]["state"], ref_grad, {},
                                    "momentum.")
                       for run in ("f32", "f32_zero_halo"))
    print(f"[spatial] (a) 1 x 2 mesh (data 1 x space 2), 2 Gloo ranks "
          f"sharing cuda:0, fundus UNet 64->1024, 3x256^2 (128 rows per "
          f"rank), batch 4+4, bf16 autocast, {DP_STEPS} steps: replicas "
          f"bit-equal (max |d| 0), uniform_rng launches "
          f"{[o['bf16']['launches'] for o in res]}; vs world 1: first-step "
          f"losses max rel |d| {loss_err:.2e} (bar {DP_LOSS_RTOL:.2e}), "
          f"after {DP_STEPS} steps ||d||/||update|| student "
          f"{shares['student.']:.2e} teacher {shares['teacher.']:.2e} "
          f"momentum {shares['momentum.']:.2e} (bar {DP_UPDATE_SHARE}); "
          f"float32 (--amp 0), 1 step, the gradient vs world 1's, "
          f"||d||/||g||: {grad:.2e} (bar {DP_GRAD_SHARE}) | {card}",
          flush=True)
    missed = [name for name, miss in (
        ("DP_LOSS_RTOL", zero_err > DP_LOSS_RTOL),
        ("DP_UPDATE_SHARE", max(zero.values()) > DP_UPDATE_SHARE),
        ("DP_GRAD_SHARE", zero_grad > DP_GRAD_SHARE)) if miss]
    print(f"[spatial] (b) the same runs with the halo rows zeroed: bf16 "
          f"first-step losses {zero_err:.2e}, student "
          f"{zero['student.']:.2e} teacher {zero['teacher.']:.2e} momentum "
          f"{zero['momentum.']:.2e}; float32 gradient {zero_grad:.2e}; "
          f"misses {missed or 'no bar'} | {card}", flush=True)
    if loss_err > DP_LOSS_RTOL or max(shares.values()) > DP_UPDATE_SHARE \
            or grad > DP_GRAD_SHARE:
        fail(f"1x2 vs world 1: losses {loss_err}, shares {shares}, float32 "
             f"gradient {grad}")
    if not missed:
        fail(f"the zeroed-halo control meets every bar: losses {zero_err}, "
             f"shares {zero}, float32 gradient {zero_grad}: the phase "
             f"cannot see a halo fault")

    t0 = time.perf_counter()
    res4 = run_dp_ranks(work, 4, [("f32", f32, 1, None)], None, spatial=2,
                        tag="sp22")
    wall_c = time.perf_counter() - t0
    for r, out in enumerate(res4):
        o = out["f32"]
        check_losses(o["metrics"], f"2x2 rank {r}")
        if o["replica_diff"] != 0.0 or o["launches"] != 1:
            fail(f"2x2 rank {r}: replica difference {o['replica_diff']}, "
                 f"uniform_rng launches {o['launches']} in 1 step")
    grad = update_share(res4[0]["f32"]["state"], ref_grad, {}, "momentum.")
    print(f"[spatial] (c) 2 x 2 mesh (data 2 x space 2), 4 Gloo ranks "
          f"sharing cuda:0, float32 (--amp 0), 1 step: replicas bit-equal, "
          f"uniform_rng launches {[o['f32']['launches'] for o in res4]}; "
          f"the gradient vs world 1's, ||d||/||g||: {grad:.2e} (bar "
          f"{DP_GRAD_SHARE}) | {card}", flush=True)
    if grad > DP_GRAD_SHARE:
        fail(f"2x2 float32 gradient vs world 1: {grad} against "
             f"{DP_GRAD_SHARE}")
    print(f"[spatial] img/s over each run's steps with the first (several "
          f"processes sharing one card: not a scaling figure; phase 13 b, 2 "
          f"data ranks, bf16: {gloo_img_s:.2f}) and peak GiB per rank "
          f"(world 1, float32, 1 step: {peak_f32:.2f}); spawn and runs "
          f"{wall_a:.1f} s (1 x 2), {wall_c:.1f} s (2 x 2) | {card}",
          flush=True)
    for label, ranks, steps in [(f"1x2 {run}", [o[run] for o in res], n)
                                for run, _, n, _ in runs] \
            + [("2x2 f32", [o["f32"] for o in res4], 1)]:
        peaks = ", ".join(f"{o['peak_gib']:.2f}" for o in ranks)
        print(f"[spatial]   {label}: {steps * batch / ranks[0]['secs']:.2f} "
              f"img/s over {steps} step(s), peak {peaks} GiB", flush=True)
    out = {f"1x2_{run}": [o[run]["launches"] for o in res]
           for run, *_ in runs}
    out["2x2_f32"] = [o["f32"]["launches"] for o in res4]
    out.update(spatial_zoo(card, work))
    return out


def zoo_world1(argv):
    """One float32 step of a zoo model at world 1, no process group: (the
    SGD momentum after it, i.e. the step's gradient, the names of its
    head's momentum entries (DeepLab's ASPP, Unet2D's seg1) and its peak
    GiB)."""
    import torch
    with LogRecords():
        plain, _ = make_trainer(argv)
    head = {f"momentum.{i}" for i, (name, _) in enumerate(
        plain.state.student.named_parameters())
        if name.startswith(("classifier.", "seg1."))}
    torch.cuda.reset_peak_memory_stats()
    plain.train_steps(1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grad = {k: v.detach().clone() for k, v in state_tensors(
        plain.state).items() if k.startswith("momentum.")}
    plain.close()
    del plain
    free_card()
    return grad, head, peak


def grad_shares(state, ref_grad, head):
    """The whole gradient's and the head's ||d||/||g|| against world 1."""
    return (update_share(state, ref_grad, {}, "momentum."),
            update_share({k: state[k] for k in head},
                         {k: ref_grad[k] for k in head}, {}, "momentum."))


def spatial_zoo(card, work):
    """Phase 15 (d)-(f): the zoo on a space axis, full-width fundus
    (3x256^2, batch 4+4, float32, the zoo's only numerics), Gloo ranks
    sharing cuda:0, one step each against world 1's: (d) DeepLabV2-R101
    on 1 x 2 (16 rows a rank at the stride-8 stages, the ASPP's 24-row
    halo reaching past the next slab), (e) the same on 1 x 4 (8 rows a
    rank: the halo crosses three slabs), (f) Unet2D on 1 x 2. The head's
    gradient (DeepLab's ASPP, Unet2D's seg1) must lie within
    DP_GRAD_SHARE of world 1's, with the replicas bit-equal and
    uniform_rng launched once per rank, and the same step with every
    halo zeroed must miss that bar. The whole gradient's distance is
    printed beside the one the data axis alone (2 x 1, no halo) reads:
    in float32 these models' ReLUs amplify a change of the BN moments'
    summation order past the bar on either axis (PERF.md §6). Returns
    the RNG kernel's launches in each run."""
    root = os.path.join(work, "fundus")
    argv = {model: train_argv(
        "fundus", root, work, f"sp_{model}", "--device", "cuda:0",
        "--model", model, "--pretrained_root",
        os.path.join(work, "no_pretrained"))
        for model in ("deeplabv2", "unet2d")}
    refs = {model: zoo_world1(a) for model, a in argv.items()}
    cases = [("d", "deeplabv2", "DeepLabV2-R101", 2),
             ("e", "deeplabv2", "DeepLabV2-R101", 4),
             ("f", "unet2d", "Unet2D", 2)]
    res = {}
    for space in (2, 4):
        runs = [(f"{model}{tail}", argv[model], 1, fault)
                for _, model, _, k in cases if k == space
                for tail, fault in (("", None), ("_zero_halo", "zero_halo"))]
        t0 = time.perf_counter()
        out = run_dp_ranks(work, space, runs, None, spatial=space,
                           tag=f"sp_zoo{space}")
        res[space] = (out, time.perf_counter() - t0)
    t0 = time.perf_counter()
    data_axis = run_dp_ranks(work, 2, [(model, a, 1, None) for model, a in
                                       argv.items()], None,
                             tag="sp_zoo_data")
    floor = {model: grad_shares(data_axis[0][model]["state"],
                                *refs[model][:2]) for model in argv}
    print(f"[spatial] the data axis alone (2 x 1, no halo), float32, 1 "
          f"step, vs world 1, ||d||/||g|| whole gradient, head: "
          + ", ".join(f"{m} {w:.2e}, {h:.2e}" for m, (w, h) in floor.items())
          + f"; {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    launches = {}
    for label, model, name, space in cases:
        out, wall = res[space]
        ref_grad, head, ref_peak = refs[model]
        for r, o in enumerate(out):
            for run in (model, f"{model}_zero_halo"):
                check_losses(o[run]["metrics"], f"({label}) rank {r} {run}")
                if o[run]["replica_diff"] != 0.0 or o[run]["launches"] != 1:
                    fail(f"({label}) {run} rank {r}: replica difference "
                         f"{o[run]['replica_diff']}, uniform_rng launches "
                         f"{o[run]['launches']} in 1 step")
        (whole, head_d), (zero, head_z) = (
            grad_shares(out[0][run]["state"], ref_grad, head)
            for run in (model, f"{model}_zero_halo"))
        peaks = ", ".join(f"{o[model]['peak_gib']:.2f}" for o in out)
        print(f"[spatial] ({label}) {name} on 1 x {space} (data 1 x space "
              f"{space}), {space} Gloo ranks sharing cuda:0, fundus "
              f"3x256^2 ({256 // space} rows a rank, {32 // space} at the "
              f"stride-8 features), batch 4+4, float32, 1 step: replicas "
              f"bit-equal, uniform_rng launches "
              f"{[o[model]['launches'] for o in out]}; vs world 1's, "
              f"||d||/||g||: head {head_d:.2e} (bar {DP_GRAD_SHARE}), whole "
              f"gradient {whole:.2e} (the data axis alone: "
              f"{floor[model][0]:.2e}); with every halo zeroed: head "
              f"{head_z:.2e}, whole "
              f"{zero:.2e} (must miss it); peak GiB per rank {peaks} "
              f"against world 1's {ref_peak:.2f} (ranks sharing one card: "
              f"memory per rank, not a scaling figure); spawn and "
              f"{space}x2 runs {wall:.1f} s | {card}", flush=True)
        if head_d > DP_GRAD_SHARE or head_z <= DP_GRAD_SHARE:
            fail(f"({label}) {name} 1 x {space} float32 head gradient vs "
                 f"world 1: {head_d}; zeroed halos {head_z}, against "
                 f"{DP_GRAD_SHARE}")
        launches[f"1x{space}_{model}"] = [o[model]["launches"] for o in out]
    return launches


def live_at_peak(snapshot):
    """The allocations live when a torch.cuda.memory snapshot's trace
    peaked: (peak bytes of the traced allocations, [(bytes, frames)] of
    those live then, largest first). Allocations made before the
    recording started are not in the trace."""
    events = [e for trace in snapshot["device_traces"] for e in trace]
    live, total, peak, peak_at = {}, 0, 0, -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            total += e["size"]
            if total > peak:
                peak, peak_at = total, i
        elif e["action"] == "free_completed" and e["addr"] in live:
            total -= live.pop(e["addr"])
    live = {}
    for e in events[:peak_at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    return peak, sorted(((e["size"], e.get("frames", [])) for e in
                         live.values()), key=lambda a: -a[0])


def where(frames):
    """The innermost frame in the port and the innermost Python frame of
    an allocation's stack (whose C++ frames come first)."""
    def name(f):
        return f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"
    py = [f for f in frames if f["filename"].endswith(".py")]
    port = [f for f in py if "ust_run_tpu_torch" in f["filename"]]
    return (name(port[0]) if port else "-", name(py[0]) if py else "-")


def memory_snapshots(card, out_path):
    """--memory FILE: one float32 step at world 1 of the fundus UNet and
    of DeepLabV2-R101 at full width (3x256^2, batch 4+4) with
    torch.cuda.memory's history recorded from the step's start; prints
    and writes to FILE (JSON) the allocations live at each step's peak,
    largest first, with the port's innermost frame that made each."""
    import torch
    from ust_run_tpu_torch.data.synthetic import generate
    work = os.path.join(HERE, "_smoke_mem")
    shutil.rmtree(work, ignore_errors=True)
    report = {"card": card}
    try:
        root = generate("fundus", os.path.join(work, "fundus"), n_train=8,
                        n_test=N_TEST, size=256, seed=0)
        for label, extra in (("unet_f32", ("--amp", "0")),
                             ("deeplabv2_r101", ("--model", "deeplabv2",
                                                 "--pretrained_root", work))):
            with LogRecords():
                trainer, _ = make_trainer(train_argv(
                    "fundus", root, work, label, *extra))
            trainer.train_steps(1)              # allocator and cuDNN warm
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.memory._record_memory_history(max_entries=400000)
            trainer.train_steps(1)
            torch.cuda.synchronize()
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            peak, live = live_at_peak(snap)
            top, by_site = [], {}
            for size, frames in live:
                site = where(frames)
                by_site[site] = by_site.get(site, 0) + size
                if len(top) < 25:
                    top.append((size / 2 ** 20, *site))
            sites = sorted(by_site.items(), key=lambda a: -a[1])[:15]
            gib = 2 ** 30
            print(f"[memory] {label}, 1 step after a warm-up step: peak "
                  f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB "
                  f"(allocated before the step {base / gib:.2f}, traced "
                  f"allocations live at the peak {peak / gib:.2f}, "
                  f"{len(live)} of them) | {card}", flush=True)
            for mib, port, inner in top[:12]:
                print(f"[memory]   {mib:9.1f} MiB  {port}  <- {inner}",
                      flush=True)
            for (port, inner), b in sites:
                print(f"[memory]   by site {b / 2 ** 20:9.1f} MiB  {port}  "
                      f"<- {inner}", flush=True)
            report[label] = dict(
                peak_gib=torch.cuda.max_memory_allocated() / gib,
                before_gib=base / gib, traced_peak_gib=peak / gib,
                top_mib=top, sites_mib=[(p, i, b / 2 ** 20)
                                        for (p, i), b in sites])
            trainer.close()
            del trainer, snap
            free_card()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)


def train_entry(argv, env):
    """`python -m ust_run_tpu_torch.train` in this process, with `env` set
    and the entry's log handlers silent (and removed after): (the trainer,
    or the code of the SystemExit it raised; its log messages)."""
    import contextlib
    import io
    import logging
    from ust_run_tpu_torch import train
    root = logging.getLogger()
    handlers = list(root.handlers)
    os.environ.update(env)
    try:
        with LogRecords() as log, contextlib.redirect_stdout(io.StringIO()):
            try:
                out = train.main(argv)
            except SystemExit as e:
                out = e.code
    finally:
        for k in env:
            del os.environ[k]
        for h in set(root.handlers) - set(handlers):
            root.removeHandler(h)
            h.close()
    return out, "\n".join(log.messages)


def phase_instruments(card, work):
    """The trainer's run control and forensics at phase 5's full width,
    through the train entry: (a) UST_STOP_AFTER_ITERS=6 with epochs of 3
    stops after two evaluations on the 30k budget's lr, (b) UST_WNORM_LOG's
    lines are there and finite, (d) --profile_dir's trace holds the RNG
    kernel of steps 2-3 (one run); (c) a large --base_lr run exits 3 with
    a UST_NAN_DEBUG dump, and `python -m ust_run_tpu_torch.nan_replay`
    reproduces its failing iteration on the card and names a module.
    Returns the RNG kernel's launches in (a)."""
    import re

    import torch
    from ust_run_tpu_torch.semisup.state import lr_at

    root = os.path.join(work, "fundus")
    prof = os.path.join(work, "trace")
    reset_launches()
    trainer, text = train_entry(
        train_argv("fundus", root, work, "stop", "--num_eval_iter", "3",
                   "--profile_dir", prof),
        {"UST_STOP_AFTER_ITERS": "6", "UST_WNORM_LOG": "1"})
    launches = rng_launches()
    payload = torch.load(os.path.join(trainer.snapshot_path,
                                      "checkpoint.pth"), map_location="cpu",
                         weights_only=True)
    lr = payload["optimizer"]["param_groups"][0]["lr"]
    full = lr_at(5, 0.03, 30000)          # the 6th update, 30k budget
    if (trainer.cfg.max_iterations, payload["step"], payload["epoch"],
            text.count("test stu model"), launches) != (30000, 6, 2, 2, 6) \
            or "UST_STOP_AFTER_ITERS=6 reached at iter 6" not in text \
            or lr != full or lr == lr_at(5, 0.03, 6):
        fail(f"(a) stop after 6: max_iterations "
             f"{trainer.cfg.max_iterations}, step {payload['step']}, epoch "
             f"{payload['epoch']}, {text.count('test stu model')} "
             f"evaluations, {launches} RNG launches, lr {lr} (30k budget: "
             f"{full})")
    health = re.findall(r"epoch (\d+) weight health: (params|bn) max (.*)",
                        text)
    values = [float(kv.split(":")[1]) for _, _, line in health
              for kv in line.split()]
    inc = [float(line.split("inc:")[1].split()[0]) for _, what, line in
           health if what == "params"]
    if len(health) != 4 or len(values) != 38 \
            or not all(math.isfinite(v) for v in values):
        fail(f"(b) weight health lines: {health}")
    trace = os.path.join(prof, "trace_rank0.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    rng_kernels = [e for e in events if e.get("cat") == "kernel"
                   and "uniform_fields_kernel" in e.get("name", "")]
    if len(rng_kernels) != 2:
        fail(f"(d) {trace} holds {len(rng_kernels)} uniform_fields_kernel "
             "launches, not 2 (steps 2-3)")
    del trainer, payload
    free_card()
    print(f"[instruments] (a) UST_STOP_AFTER_ITERS=6, epochs of 3, full "
          f"width: stopped at step 6 after 2 evaluations and checkpoints, "
          f"max_iterations 30000, last lr {lr:.9g} (30k schedule; a 6-step "
          f"budget would give {lr_at(5, 0.03, 6):.6g}); uniform_rng launches "
          f"{launches}; (b) UST_WNORM_LOG: 2 epochs x params/bn lines, "
          f"{len(values)} finite values, inc params max "
          f"{', '.join(f'{v:.3e}' for v in inc)}; (d) --profile_dir: "
          f"{len(events)} trace events, uniform_fields_kernel in steps 2-3 "
          f"{len(rng_kernels)} times ({os.path.getsize(trace) / 2 ** 20:.1f} "
          f"MiB) | {card}", flush=True)

    # (c) a legitimate flag that diverges: --base_lr NAN_LR
    dump = os.path.join(work, "nan")
    argv = train_argv("fundus", root, work, "nan", "--num_eval_iter",
                      str(NAN_MAX_ITERS), "--base_lr", NAN_LR)
    t0 = time.perf_counter()
    code, text = train_entry(argv, {
        "UST_NAN_DEBUG": dump, "UST_NAN_SNAP": "2",
        "UST_STOP_AFTER_ITERS": str(NAN_MAX_ITERS)})
    free_card()
    found = re.findall(r"non-finite (\S+) at iteration (\d+); snapshot of "
                       r"iteration (\d+)", text)
    if code != 3 or not found or not os.path.exists(
            os.path.join(dump, "state.pt")):
        fail(f"(c) --base_lr {NAN_LR}: exit {code} (3 expected), dump "
             f"{os.listdir(dump) if os.path.isdir(dump) else None}\n"
             f"{text[-2000:]}")
    terms, fail_it, snap_it = found[0]
    replay = subprocess.run(
        [sys.executable, "-m", "ust_run_tpu_torch.nan_replay", "--dump",
         dump, "--health-every", "1", "--", *argv], cwd=HERE,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": HERE})
    again = re.findall(r"=== first non-finite at iter (\d+):", replay.stdout)
    named = re.findall(r"first non-finite module output: "
                       r"((?:student|teacher)\S*)", replay.stdout)
    if replay.returncode != 1 or again != [fail_it] or not named:
        fail(f"(c) nan_replay: rc {replay.returncode} (1 expected), failing "
             f"iteration {again} (trainer: {fail_it}), module {named}\n"
             f"{replay.stdout[-3000:]}\n{replay.stderr[-2000:]}")
    health = [ln for ln in replay.stdout.splitlines()
              if ln.startswith("iter ")]
    print(f"[instruments] (c) --base_lr {NAN_LR}, UST_NAN_SNAP=2: exit 3, "
          f"non-finite {terms} at iteration {fail_it}, snapshot of "
          f"iteration {snap_it} dumped; nan_replay on the card: rc 1, first "
          f"non-finite at iteration {again[0]} (the same), first module with "
          f"a non-finite output {named[0]}; last health line before it: "
          f"{health[-2] if len(health) > 1 else '-'}; "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    shutil.rmtree(dump, ignore_errors=True)
    return launches


UNROLL_STEPS = (3, 30)        # phase 17 (b): a capturing call, then replays
PROFILED_REPLAYS = 10         # phase 17: replays in the profiler's window
# phase 17 (b): the zoo, float32, each replayed step against the same step
# run eagerly from the same state, twice (R101 once): every metric row and
# state tensor equal. Under --deterministic 1 the zoo's step has no
# operator whose sums change from run to run (its resizes are matrix
# products, cuDNN runs deterministic algorithms), as the UNet's has had
# none since its per-group means became an averaging-matrix product
ZOO_PAIRS = (("deeplabv2_r50", SHORT_STEPS - 1, 2),
             ("unet2d", SHORT_STEPS - 1, 2),
             ("deeplabv2", 1, 1))     # (model, replayed steps, eager runs)


def replay_fields(key_of):
    """Fields of two replays of a captured uniform_fields call whose key is
    `key_of(static)`, `static` a (2,) int32 device key rewritten to
    RNG_SEED's and then RNG_SEED + 1's words before each replay."""
    import torch
    from ust_run_tpu_torch.ops import rng
    n, size = RNG_SHAPE
    static = torch.zeros(2, dtype=torch.int32, device="cuda")
    out = torch.empty((n, size, size), device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rng.uniform_fields(out, key_of(static))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rng.uniform_fields(out, key_of(static))
    fields = []
    for seed in (RNG_SEED, RNG_SEED + 1):
        static.copy_(torch.from_numpy(rng.key_words(seed)))
        graph.replay()
        fields.append(out.clone())
    return fields


def keyed(fields):
    """Whether each replay drew its own key's fields."""
    import torch
    from ust_run_tpu_torch.ops import rng
    n, size = RNG_SHAPE
    return all(torch.equal(f, rng.uniform_batch_plain(n, size, s, "cuda"))
               for f, s in zip(fields, (RNG_SEED, RNG_SEED + 1)))


def unroll_run(root, work, tag, extra, first, rest, mesh=None):
    """A fresh trainer's `first` steps (on `mesh` if given), then `rest`
    under the sync debug mode. Returns (the trainer, (metric rows, host
    state, ms per step of the rest, peak GiB, uniform_rng launches run,
    graph counts))."""
    import torch
    from ust_run_tpu_torch.engine import checkpoint as ckpt
    from ust_run_tpu_torch.semisup import step
    trainer, _ = make_trainer(train_argv("fundus", root, work, tag, *extra),
                              mesh)
    free_card()
    reset_launches()
    rows = trainer.train_steps(first)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows += trainer.train_steps(rest)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / max(rest, 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    state = ckpt.host_copy(ckpt.state_payload(trainer.state, 0, (0, 0, 0, 0),
                                              {}))
    return trainer, (rows, state, ms, peak, rng_launches(),
                     dict(step.graph_counts))


def state_leaves(payload, prefix=""):
    """(name, tensor) of every tensor in a nested payload."""
    import torch
    if torch.is_tensor(payload):
        yield prefix, payload
    elif isinstance(payload, dict):
        for k, v in payload.items():
            yield from state_leaves(v, f"{prefix}.{k}")


def rows_and_state_diff(a, b):
    """(metric rows that differ, state tensors that differ) of two runs."""
    import numpy as np
    import torch
    rows = [i for i, (x, y) in enumerate(zip(a[0], b[0]))
            if any(not np.array_equal(x[k], y[k]) for k in x)]
    sb = dict(state_leaves(b[1]))
    state = [k for k, v in state_leaves(a[1]) if not torch.equal(v, sb[k])]
    return rows, state


def zoo_graph_vs_eager(root, work, model, replays, eager_runs):
    """--model `model` at --unroll_steps 10: a capturing call of one step,
    then `replays` calls of one replay; each replayed step is also run
    `eager_runs` times as an eager step from the state before it (the
    trainer's state restored in place, the samplers too), and the trainer
    goes on from the replay's state. Returns (for each replayed step, the
    metric rows and state tensors of each eager run that differ from the
    replay's; peak GiB)."""
    import numpy as np
    import torch
    from ust_run_tpu_torch.nan_replay import restore
    from ust_run_tpu_torch.semisup import step as step_mod

    trainer, _ = make_trainer(train_argv(
        "fundus", root, work, model, "--model", model, "--pretrained_root",
        os.path.join(work, "no_pretrained")))
    free_card()

    def back_to(payload):
        restore(trainer, payload)
        trainer.iter_num = trainer.state.step

    def step(unroll):
        trainer.unroll = unroll
        rows = trainer.train_steps(1)
        check_losses(rows, f"{model} unroll {unroll}")
        return rows, {k: v.detach().to("cpu", copy=True)
                      for k, v in state_tensors(trainer.state).items()}

    reset_launches()
    step(10)
    diffs = []
    for _ in range(replays):
        before = trainer.host_payload(trainer.state.epoch)
        graph = step(10)
        after = trainer.host_payload(trainer.state.epoch)
        for _ in range(eager_runs):
            back_to(before)
            eager = step(1)
            diffs.append(
                [k for k in graph[0][0] if not np.array_equal(
                    graph[0][0][k], eager[0][0][k])]
                + [k for k in graph[1] if not torch.equal(graph[1][k],
                                                          eager[1][k])])
        back_to(after)
    counts = step_mod.graph_counts
    if (counts["captures"], counts["replays"]) != (1, replays):
        fail(f"(b) {model} graph counts {counts}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer.close()
    return diffs, peak


def phase_unroll(card, work):
    """--unroll_steps on the card (the trainer's K-step call, one captured
    CUDA graph of the step replayed per step): (a) the RNG kernel's
    kernel bit-equal to its plain version for keys with the high words
    set, and inside a captured graph two replays with two keys draw those
    keys' fields, while the control (a key tensor made at capture and
    never rewritten, as a key passed by value would be) must fail that
    check; (b) fundus at full width, bf16, 33 steps on the graph path (a
    call of 3 capturing it, 3 calls of 10 replays) against 33 eager steps
    of a trainer from the same seed: metric rows and state bit-equal;
    then the zoo (ZOO_PAIRS, `zoo_graph_vs_eager`), each replayed step
    bit-equal to the same step run eagerly from the same state; (c) the
    replays under the sync debug mode; (d) peak GiB, graph against eager;
    and a profiler window of PROFILED_REPLAYS replays holding as many
    uniform_rng kernels by name (or one fewer: the profiler can miss a
    kernel). Returns the launches that ran in (b)'s graph run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ust_run_tpu_torch.data.synthetic import generate
    from ust_run_tpu_torch.ops import rng

    n, size = RNG_SHAPE
    for seed in (RNG_SEED, 2 ** 63 + 12345, 2 ** 64 - 1):
        key = torch.from_numpy(rng.key_words(seed))
        got = rng.uniform_fields(torch.empty((n, size, size), device="cuda"),
                                 key.cuda())
        if not torch.equal(got.cpu(), rng.uniform_batch_plain(n, size, key)):
            fail(f"uniform_rng differs from its plain version for key "
                 f"{seed:#x}")
    if not keyed(replay_fields(lambda static: static)):
        fail("two replays of a captured uniform_rng launch did not draw "
             "their keys' fields")
    fixed = torch.from_numpy(rng.key_words(RNG_SEED)).cuda()
    frozen = replay_fields(lambda static: fixed)
    if keyed(frozen) or not torch.equal(*frozen):
        fail("the control (a key frozen at capture) passed the check")
    print(f"[unroll] (a) uniform_rng bit-equal to plain "
          f"at {(n, size, size)} for keys with the high word 0x5EED, "
          f"0x80000000 and 0xFFFFFFFF; in a captured graph two replays drew "
          f"their two keys' fields, the control with the key frozen at "
          f"capture drew equal fields twice and failed the check | {card}",
          flush=True)

    root = generate("fundus", os.path.join(work, "unroll"), n_train=8,
                    n_test=2, size=256, seed=0)
    graph_tr, graph = unroll_run(root, work, "graph", [], *UNROLL_STEPS)
    rows_g, _, ms_g, peak_g, runs_g, counts_g = graph
    steps = sum(UNROLL_STEPS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph_tr.train_steps(PROFILED_REPLAYS)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e.name for e in prof.events() if e.device_type == cuda]
    rng_named = sum("uniform_fields_kernel" in k for k in kernels)
    graph_tr.close()
    del graph_tr
    free_card()
    eager_tr, eager = unroll_run(root, work, "eager", ["--unroll_steps", "1"],
                                 *UNROLL_STEPS)
    eager_tr.close()
    del eager_tr
    _, _, ms_e, peak_e, runs_e, counts_e = eager
    diff_rows, diff_state = rows_and_state_diff(graph, eager)
    check_losses(rows_g, "unroll graph")
    if (runs_g, runs_e, counts_g["captures"], counts_g["replays"],
            counts_e["replays"]) != (steps, steps, 1, steps - 1, 0):
        fail(f"(b) uniform_rng runs {runs_g} / {runs_e}, graph counts "
             f"{counts_g} / {counts_e} in {steps} steps")
    if diff_rows or diff_state:
        fail(f"(b) graph against eager: rows {diff_rows[:5]}, state "
             f"{diff_state[:5]} differ")
    # the profiler can miss a kernel of its window (phase 18 allows the
    # same), never two
    if rng_named not in (PROFILED_REPLAYS - 1, PROFILED_REPLAYS):
        fail(f"the profiler saw {rng_named} uniform_fields_kernel in "
             f"{PROFILED_REPLAYS} replays")
    print(f"[unroll] (b) fundus UNet, bf16, {steps} steps: graph path (1 "
          f"capture, {counts_g['replays']} replays) bit-equal to eager "
          f"steps: {len(rows_g)} metric rows and "
          f"{len(list(state_leaves(graph[1])))} state tensors; (c) "
          f"{UNROLL_STEPS[1]} replays under the sync debug mode; "
          f"{ms_g:.1f} ms/step against {ms_e:.1f} eager; (d) peak "
          f"{peak_g:.2f} GiB against {peak_e:.2f} eager; uniform_rng runs "
          f"{runs_g} / {runs_e}; profiler: "
          f"{len(kernels) / PROFILED_REPLAYS:.0f} kernels a replayed step, "
          f"uniform_fields_kernel {rng_named} in {PROFILED_REPLAYS} | "
          f"{card}", flush=True)
    del graph, eager

    for model, replays, eager_runs in ZOO_PAIRS:
        diffs, peak = zoo_graph_vs_eager(root, work, model, replays,
                                         eager_runs)
        free_card()
        if any(diffs):
            fail(f"(b) {model}: a replayed step and the same step run "
                 f"eagerly from one state differ at {[d[:4] for d in diffs]}")
        print(f"[unroll] (b) {model}, float32, a capturing call of 1 step, "
              f"then {replays} replayed step(s), each also run eagerly "
              f"{eager_runs} time(s) from the state before it (restored in "
              f"place): {replays * eager_runs} eager step(s) bit-equal to "
              f"the replay in every metric and state tensor; peak "
              f"{peak:.2f} GiB | {card}", flush=True)
    return runs_g


BENCH_RUNS = [({}, "ssl_train_images_per_sec_per_chip", 10),
              ({"UST_BENCH_MODEL": "deeplabv2_r50", "UST_BENCH_UNROLL": "2"},
               "ssl_train_images_per_sec_per_chip_deeplabv2_r50", 2)]
# stage clock against CUDA events (phase 16): the stamps' own ~1 us and the
# events' 0.5 us resolution against spans of milliseconds
STAGE_RTOL = 0.05
STAGE_REPLAYS = 5


def run_module(module, args=(), env=None):
    """`python -m module args` in a fresh process on the card with `env`
    added; fails unless it exits 0. Returns (stdout, stderr)."""
    proc = subprocess.run(
        [sys.executable, "-m", module, *args], cwd=HERE, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": HERE, **(env or {})})
    if proc.returncode != 0:
        fail(f"python -m {module} {' '.join(args)} {env or ''}: rc "
             f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-3000:]}")
    return proc.stdout, proc.stderr


def bench_run(env, metric, unroll):
    """One `python -m ust_run_tpu_torch.bench` with `env`: (its JSON line,
    its stderr report), both checked."""
    out, err = run_module("ust_run_tpu_torch.bench", env=env)
    lines = out.strip().splitlines()
    if len(lines) != 1:
        fail(f"bench {env}: {len(lines)} stdout lines, not one:\n{out}")
    res = json.loads(lines[0])
    report = [ln for ln in err.splitlines() if ln.startswith("[bench] {")]
    if not report:
        fail(f"bench {env}: no report on stderr\n{err[-2000:]}")
    info = json.loads(report[-1][len("[bench] "):])
    value = res.get("value")
    if res.get("metric") != metric or not isinstance(value, float) \
            or not math.isfinite(value) or value <= 0:
        fail(f"bench {env}: {lines[0]}")
    steps = (3 + 8) * unroll
    graph = (1, steps - 1) if unroll > 1 else (0, 0)
    if (info["steps_run"], info["steps_timed"],
            info["uniform_rng_launches"], info["graph_captures"],
            info["graph_replays"]) != (steps, 8 * unroll, steps, *graph) \
            or not math.isfinite(info["last_loss"]):
        fail(f"bench {env}: {report[-1]}")
    return res, info


def phase_bench(card):
    """The benchmark entries in fresh processes, then one bench step under
    the sync debug mode. Returns uniform_rng's launches in the default
    bench run."""
    import torch
    from ust_run_tpu_torch import bench
    from ust_run_tpu_torch.utils import trace
    infos = []
    for env, metric, unroll in BENCH_RUNS:
        t0 = time.perf_counter()
        res, info = bench_run(env, metric, unroll)
        infos.append(info)
        print(f"[bench] {json.dumps(res)}\n[bench] {json.dumps(info)}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    cfg, _ = bench.bench_config({})
    cfg.unroll_steps = 1
    b = bench.Bench(cfg, "cuda")
    b.calls(1)
    torch.cuda.synchronize()
    trace.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        last = b.calls(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not math.isfinite(float(last[0])):
        fail(f"bench step under the sync debug mode: loss {last[0]}")
    del b
    stages = trace.stage_totals("cuda", "eager")
    if any(n != 1 or not sec > 0 for n, sec in stages.values()) \
            or any(n for n, _ in trace.stage_totals("cuda", "graph").values()):
        fail(f"bench step's stage clock: {stages}")
    ms = {name: round(sec * 1e3, 3) for name, (_, sec) in stages.items()}
    print("[bench] one bench step (index copy, step, lagged fetch) under "
          "torch.cuda.set_sync_debug_mode('error'): no host-device sync; "
          f"its stage clock (device ms): {json.dumps(ms)} | {card}",
          flush=True)
    stage_clock_spins(card)
    stage_clock_replays(card)
    return infos[0]["uniform_rng_launches"]


def near(got, want):
    return abs(got - want) <= STAGE_RTOL * want


def stage_clock_spins(card):
    """The stamp kernel's arithmetic on known work: spins in
    `step.inputs` around a nested `step.teacher_fwd`, each stretch timed
    by CUDA events recorded just after the stamps, the card kept busy
    while the host queues them (else the card's wait for the host, which
    the clock rightly counts, lies outside the events). The clock has to
    give each span its own spins' time (in seconds), the outer one
    without the inner one's, eagerly and summed over the replays of a
    capture."""
    import torch
    from ust_run_tpu_torch.utils import trace
    dev = torch.device("cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    spin = 2_000_000                  # cycles: ~1 ms at the boost clock

    def block(mark):
        with trace.span("step.inputs", dev):
            mark(0)
            torch.cuda._sleep(spin)
            with trace.span("step.teacher_fwd", dev):
                mark(1)
                torch.cuda._sleep(3 * spin)
                mark(2)
            mark(3)
            torch.cuda._sleep(spin)
            mark(4)

    def timed(i):
        ev[i].record()

    def untimed(i):
        pass

    def clocked(path, n):
        got = trace.stage_totals(dev, path)
        if {s: c for s, (c, _) in got.items()} != {
                s: n * (s in ("step.inputs", "step.teacher_fwd"))
                for s in trace.STAGES}:
            fail(f"stage clock spins, {path}: counts {got}")
        return got["step.inputs"][1] * 1e3, got["step.teacher_fwd"][1] * 1e3

    for _ in range(2):                # warm the clocks
        block(untimed)
    torch.cuda.synchronize()
    trace.reset()
    torch.cuda._sleep(5 * spin)       # the card busy while the host queues
    block(timed)
    torch.cuda.synchronize()
    inner = ev[1].elapsed_time(ev[2])
    outer = ev[0].elapsed_time(ev[1]) + ev[3].elapsed_time(ev[4])
    whole = ev[0].elapsed_time(ev[4])
    inputs, teacher = clocked("eager", 1)
    if not (near(teacher, inner) and near(inputs, outer)
            and near(inputs + teacher, whole)):
        fail(f"stage clock spins, eager (ms): inputs {inputs} against "
             f"{outer}, teacher_fwd {teacher} against {inner}, sum against "
             f"{whole}")

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        block(untimed)
    torch.cuda.synchronize()
    trace.reset()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(5 * spin)
    start.record()
    for _ in range(STAGE_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    g_inputs, g_teacher = clocked("graph", STAGE_REPLAYS)
    clocked("eager", 0)
    g_whole = start.elapsed_time(end)
    if not (near(g_teacher, STAGE_REPLAYS * inner)
            and near(g_inputs, STAGE_REPLAYS * outer)
            and near(g_inputs + g_teacher, g_whole)):
        fail(f"stage clock spins, {STAGE_REPLAYS} replays (ms): inputs "
             f"{g_inputs}, teacher_fwd {g_teacher}, sum against {g_whole}; "
             f"one eager block: {outer}, {inner}")
    del graph
    trace.reset()
    print(f"[bench] stage clock on spins (ms, clock against CUDA events): "
          f"eager inputs {inputs:.4f} / {outer:.4f}, teacher_fwd "
          f"{teacher:.4f} / {inner:.4f}, sum {inputs + teacher:.4f} / "
          f"{whole:.4f}; {STAGE_REPLAYS} replays: {g_inputs:.4f}, "
          f"{g_teacher:.4f}, sum {g_inputs + g_teacher:.4f} / {g_whole:.4f} "
          f"| {card}", flush=True)


def stage_clock_replays(card):
    """The bench at 10 steps a call: after the capturing call, 2 calls
    count 20 replays, each clocked span 20 times on the graph path and
    none on the eager path, and the stages add up to the calls' CUDA-event
    time."""
    import torch
    from ust_run_tpu_torch import bench
    from ust_run_tpu_torch.semisup import step as pstep
    from ust_run_tpu_torch.utils import trace
    cfg, _ = bench.bench_config({})
    cfg.unroll_steps = 10
    b = bench.Bench(cfg, "cuda")
    b.calls(1)
    torch.cuda.synchronize()
    pstep.reset_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    b.calls(2)
    end.record()
    torch.cuda.synchronize()
    replays = pstep.graph_counts["replays"]
    graph = trace.stage_totals("cuda", "graph")
    eager = trace.stage_totals("cuda", "eager")
    call_ms = start.elapsed_time(end)
    total = sum(sec for _, sec in graph.values()) * 1e3
    if replays != 20 or any(n != replays or not sec > 0
                            for n, sec in graph.values()) \
            or any(n for n, _ in eager.values()) or not near(total, call_ms):
        fail(f"bench stage clock on the graph path: {replays} replays, "
             f"graph {graph}, eager {eager}, sum {total} ms against "
             f"{call_ms} ms")
    del b
    ms = {name: round(sec * 1e3 / replays, 3)
          for name, (_, sec) in graph.items()}
    print(f"[bench] 2 calls of 10 replays: each clocked span counted "
          f"{replays} times on the graph path, none eager; stages "
          f"{total:.2f} ms against {call_ms:.2f} ms by CUDA events; ms a "
          f"step {json.dumps(ms)} | {card}", flush=True)


def steps_one_by_one(trainer, n):
    """`n` steps, each timed on its own (host clock to a synchronise; the
    first includes warm-up). Returns (ms per step, metrics, peak GiB)."""
    import torch
    times, metrics = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        metrics += trainer.train_steps(1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, metrics, torch.cuda.max_memory_allocated() / 2 ** 30


def step_window(trainer, warmup, timed):
    """`warmup` steps, then `timed` steps under the sync debug mode, in
    which any host-device synchronisation raises (the trainer's metric
    fetch waits on a recorded event, which is not one). Returns (metrics
    of every step, seconds of the timed steps, peak GiB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = trainer.train_steps(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics += trainer.train_steps(timed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return metrics, dt, torch.cuda.max_memory_allocated() / 2 ** 30


def unet_forward_gflop(model, size, channels, device):
    """Convolution FLOPs (2 x multiply-adds) of one image's forward,
    counted with hooks on a batch-1 forward in eval mode."""
    import torch
    macs = []

    def hook(mod, inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            macs.append(inp[0].numel() * mod.out_channels * k)
        else:
            macs.append(out.numel() * mod.in_channels * k)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    model.eval()
    with torch.no_grad():
        model(torch.zeros((1, size, size, channels), device=device))
    model.train()
    for h in hooks:
        h.remove()
    return 2 * sum(macs) / 1e9


def phase_profile(card, trainer, step_ms, out_path, label="profile"):
    """PROFILED_STEPS more steps of a path's trainer under torch.profiler
    (CPU and CUDA activities); writes the summary to `out_path` and
    returns it."""
    import torch
    hp = trainer.hp
    gflop = unet_forward_gflop(trainer.state.student, hp.patch, hp.channels,
                               trainer.device)
    # teacher: 3 groups of unlabel_bs forwards; student: 5 groups of 4 plus
    # the LQ image, forward and backward (~3 forwards)
    n_fwd = 3 * hp.unlabel_bs + 3 * (4 * hp.unlabel_bs + hp.label_bs + 1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_steps(PROFILED_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    n = PROFILED_STEPS
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kernel_us = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == cuda)
    n_kernels = sum(1 for e in events if e.device_type == cuda)
    host = [e for e in events if e.device_type != cuda]
    syncs = {name: [e.time_range.elapsed_us() / 1e3 for e in host
                    if e.name == name] for name in SYNC_CALLS}
    launch_us = sum(e.time_range.elapsed_us() for e in host
                    if "LaunchKernel" in e.name)

    def device_us(evt):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                return getattr(evt, name)
        return 0.0

    averages = [e for e in prof.key_averages() if e.device_type != cuda]
    ops = sorted((e for e in averages if device_us(e) > 0), key=device_us,
                 reverse=True)
    host_ops = sorted(averages, key=lambda e: e.self_cpu_time_total,
                      reverse=True)
    summary = {
        "card": card, "steps": n,
        "unprofiled_ms_per_step": step_ms,
        "wall_ms_per_step": wall * 1e3 / n,
        "device_kernel_ms_per_step": kernel_us / 1e3 / n,
        "device_busy_share": kernel_us / 1e6 / wall,
        "device_busy_share_unprofiled": kernel_us / 1e3 / n / step_ms,
        "kernel_launches_per_step": n_kernels / n,
        "launch_api_ms_per_step": launch_us / 1e3 / n,
        "sync_call_ms": syncs,
        "conv_gflop_per_image_forward": gflop,
        "conv_tflop_per_step": gflop * n_fwd / 1e3,
        "top_ops": [{"op": e.key, "device_ms_per_step": device_us(e) / 1e3 / n,
                     "calls_per_step": e.count / n} for e in ops[:25]],
        "top_host_ops": [{"op": e.key, "calls_per_step": e.count / n,
                          "self_host_ms_per_step":
                              e.self_cpu_time_total / 1e3 / n}
                         for e in host_ops[:25]],
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[{label}] {n} steps: wall {summary['wall_ms_per_step']:.1f} "
          f"ms/step under the profiler ({step_ms:.1f} without), device "
          f"kernels {summary['device_kernel_ms_per_step']:.1f} ms/step, busy "
          f"{summary['device_busy_share']:.3f} "
          f"({summary['device_busy_share_unprofiled']:.3f} of the unprofiled "
          f"step), {summary['kernel_launches_per_step']:.0f} kernels/step, "
          f"sync calls " + ", ".join(f"{k} {len(v)}" for k, v in syncs.items())
          + f"; convs {gflop:.2f} GFLOP per image forward; -> {out_path} | "
          f"{card}", flush=True)
    return summary


def ab_run(card, spec, profile_out):
    """One run of --ab, in this process: phase 5's trainer and step window
    (AB_STEPS timed steps) with TREE's package, on a one-rank NCCL group
    for `TREE@nccl` (at --unroll_steps 1 for `TREE@nccl-eager`); then,
    with `profile_out`, phase 6's profile. Prints one JSON line."""
    tree, _, mode = spec.partition("@")
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from ust_run_tpu_torch.data.synthetic import generate
    from ust_run_tpu_torch.engine.trainer import set_numerics

    set_numerics()
    work = os.path.join(tree, "_smoke_ab")
    shutil.rmtree(work, ignore_errors=True)
    mesh = prof = None
    try:
        root = generate("fundus", os.path.join(work, "fundus"), n_train=8,
                        n_test=N_TEST, size=256, seed=0)
        if mode.startswith("nccl"):
            from ust_run_tpu_torch import parallel
            mesh = parallel.init_distributed(
                backend="nccl", device="cuda:0", rank=0, world_size=1,
                init_method="file://" + os.path.join(work, "store"))
        extra = ["--unroll_steps", "1"] if mode == "nccl-eager" else []
        trainer, cfg = make_trainer(train_argv("fundus", root, work, "ab",
                                               *extra), mesh)
        metrics, dt, peak_gib = step_window(trainer, WARMUP_STEPS, AB_STEPS)
        check_losses(metrics, spec)
        step_ms = dt / AB_STEPS * 1e3
        if profile_out:
            prof = phase_profile(card, trainer, step_ms, profile_out,
                                 f"ab {spec}")
        trainer.close()
    finally:
        if mesh is not None:
            mesh.close()
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({
        "tree": tree, "mode": mode or "plain",
        "img_s": AB_STEPS * (cfg.label_bs + cfg.unlabel_bs) / dt,
        "ms_step": step_ms, "peak_gib": peak_gib,
        "last_loss": float(metrics[-1]["loss"]),
        "profile": prof and {k: prof[k] for k in (
            "wall_ms_per_step", "device_kernel_ms_per_step",
            "kernel_launches_per_step", "launch_api_ms_per_step")},
        "card": card}), flush=True)


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="FILE", default=None,
                    help="also profile the main path; write JSON to FILE")
    ap.add_argument("--ab", metavar="TREE[@nccl]", nargs="+", default=None,
                    help="only time the main path of each tree, in order, "
                    "each in a fresh process")
    ap.add_argument("--ab-run", metavar="TREE[@nccl]", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--memory", metavar="FILE", default=None,
                    help="only record the allocations live at the peak of "
                    "one float32 UNet and one DeepLabV2-R101 step; JSON to "
                    "FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA GPU")
    if args.memory:
        sys.path.insert(0, HERE)
        from ust_run_tpu_torch.engine.trainer import set_numerics
        set_numerics()
        return memory_snapshots(card_line(), args.memory)
    if args.ab_run:
        return ab_run(card_line(), args.ab_run, args.profile)
    if args.ab:
        print(card_line(), flush=True)
        stem = args.profile and os.path.splitext(args.profile)[0]
        for i, spec in enumerate(args.ab):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--ab-run", spec] + (
                ["--profile", f"{stem}_{i}.json"] if stem else []),
                check=True)
        return
    sys.path.insert(0, HERE)
    from ust_run_tpu_torch.engine.trainer import set_numerics
    from ust_run_tpu_torch.ops import cuda_build
    from ust_run_tpu_torch.utils import boundary_native

    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    builds = [functools.partial(cuda_build.build, "uniform_rng"),
              functools.partial(cuda_build.build, "fused_conv"),
              boundary_native.build,
              functools.partial(cuda_build.build, "grouped_bn")]
    with ThreadPoolExecutor(len(builds)) as pool:    # every compiler at once
        libs = list(pool.map(lambda build: build(), builds))
    print(f"[build] " + ", ".join(os.path.relpath(lib, HERE) for lib in libs)
          + f" in {time.perf_counter() - t0:.1f} s (in parallel)", flush=True)
    for line in ptxas_report(libs[1] + ".log"):
        print(f"[build] fused_conv.cu ptxas: {line}", flush=True)
    for line in ptxas_report(libs[3] + ".log"):
        print(f"[build] grouped_bn.cu ptxas: {line}", flush=True)

    set_numerics()

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        print(f"[time] {name}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    kernels = timed("kernels", phase_kernels, card) \
        + [timed("fused conv", phase_fused_conv, card),
           timed("grouped bn", phase_grouped_bn, card)]
    timed("reference", phase_reference, card)
    timed("fused sgd", phase_fused_sgd, card)
    work = os.path.join(HERE, "_smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        launches, trainer, argv, main_img_s = timed(
            "main path", phase_main_path, card, work, args.profile)
        timed("eval", phase_eval, card, trainer, argv)
        del trainer
        free_card()
        timed("busi", phase_busi, card, work)
        free_card()
        timed("zoo reference", phase_zoo_reference, card)
        free_card()
        zoo_launches = timed(
            "zoo path", phase_zoo_path, card, work,
            args.profile and os.path.splitext(args.profile)[0] + "_zoo.json")
        timed("zoo short", phase_zoo_short, card, work)
        timed("prostate, mnms", phase_prostate_mnms, card, work)
        free_card()
        gloo_img_s, dp_launches = timed("data parallel", phase_data_parallel,
                                        card, work, main_img_s, args.profile)
        free_card()
        instruments_launches = timed("instruments", phase_instruments, card,
                                     work)
        free_card()
        spatial_launches = timed("spatial", phase_spatial, card, work,
                                 gloo_img_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    free_card()
    bench_launches = timed("bench", phase_bench, card)
    try:
        unroll_launches = timed("unroll", phase_unroll, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    free_card()
    timed("rng timing", phase_rng_timing, card, kernels[0])
    print(f"[time] all: {time.perf_counter() - t0:.1f} s", flush=True)
    for k in kernels:
        if k["name"] == "uniform_rng":
            k["launches"] = launches["uniform_rng"]
            k["launches_counted_as"] = (
                "launches outside CUDA graphs (the wrapper's count) plus, "
                "for each replay of the captured step, its captured launch")
            k["unroll_launches"] = unroll_launches
            k["zoo_path_launches"] = zoo_launches
            k["data_parallel_launches"] = dp_launches
            k["instruments_launches"] = instruments_launches
            k["spatial_launches"] = spatial_launches
            k["bench_launches"] = bench_launches
            k["bit_equal_at"] = ["(16,256,256)", "(3,37,37)",
                                 "(16,384,384)", "(16,288,288)"]
        else:
            # its path is the microbench; the model never calls it
            k["main_path_launches"] = launches[k["name"]]
        for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                    "max_abs_err"):
            if key not in k:
                continue
            if k[key] is not None and not math.isfinite(k[key]):
                fail(f"{k['name']}: {key} = {k[key]}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
