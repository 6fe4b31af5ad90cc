#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ust_run_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile FILE]

Phases, one line each; any failure exits non-zero:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the main path from
     ust_run_tpu_torch/csrc/ (nvcc, sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card
     (the uniform-field RNG must be bit-equal at the main path's shape and
     at a ragged one, and pass the statistical bar), with its time, its
     bound and the time of the nearest PyTorch library call;
  4. reference: the port's UNet train forward and gradients on the card
     against the same module on the CPU (float32, TF32 off) at a small
     input;
  5. main path: the port's trainer on a synthetic fundus corpus at full
     width (UNet 64->1024, 3x256^2, batch 4+4): 3 warm-up and 10 timed
     steps, every loss finite, the RNG kernel launched once per step, and
     no call in the timed steps that makes the host wait on the card
     (`torch.cuda.set_sync_debug_mode("error")`) other than the trainer's
     one-step-behind metric fetch;
  6. profile (only with --profile FILE): 5 more steps of the same trainer
     under torch.profiler: wall and device-kernel ms per step, the
     device's busy share, kernel launches per step, the host's time
     blocked in synchronising CUDA calls, the top operators by device
     time and the convolutions' FLOPs; written to FILE as JSON.
Then a JSON line with the kernels' numbers, the card line again, and
`{"ok": true, "device": {...}}` as the last line.

Synthetic data, the trainer's log and the kernel build stay inside the
checkout (`_smoke/`, `ust_run_tpu_torch/_build/`); `_smoke/` is removed
at the end.
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_NONTENSOR_OPS_PER_S = 67e12  # f32 outside the tensor cores (proxy for
#                                   32-bit integer work)
PHILOX_OPS_PER_QUAD = 112        # 10 rounds x (2 mulhi + 2 mullo + 4 xor +
#                                  2 key adds) + 4 x (shift, convert, scale)
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 10, 5
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
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


def phase_kernels(card):
    import torch
    from ust_run_tpu_torch.ops import rng

    seed = 0x5EED_0F_F1E1D5
    for n, size in ((16, 256), (3, 37)):
        out = torch.empty((n, size, size), device="cuda")
        rng.uniform_fields(out, seed)
        torch.cuda.synchronize()
        plain = rng.uniform_batch_plain(n, size, seed, device="cuda")
        if not torch.equal(out, plain):
            fail(f"uniform_rng differs from its plain version at "
                 f"{(n, size, size)}: max |d| "
                 f"{(out - plain).abs().max().item()}")
    n, size = 16, 256
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

    ms = cuda_ms(lambda: rng.uniform_fields(out, seed), 200)
    plain_ms = cuda_ms(lambda: rng.uniform_batch_plain(n, size, seed,
                                                       device="cuda"), 10)
    g = torch.Generator(device="cuda").manual_seed(0)
    lib_ms = cuda_ms(lambda: torch.rand((n, size, size), device="cuda",
                                        generator=g), 200)
    nbytes = n * size * size * 4
    quads = n * ((size * size + 3) // 4)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = quads * PHILOX_OPS_PER_QUAD / H100_NONTENSOR_OPS_PER_S * 1e3
    entry = dict(name="uniform_rng", route="cuda",
                 source="ust_run_tpu_torch/csrc/uniform_rng.cu",
                 replaces="ust_run_tpu/ops/pallas_rng.py:22",
                 launches=None, max_abs_err=max_err, ms=ms,
                 plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 library_ms=lib_ms)
    print(f"[kernels] uniform_rng bit-equal to plain at (16,256,256) and "
          f"(3,37,37); min {lo:.3g} max {hi:.9f} mean {mean:.5f} "
          f"std {std:.5f}; {ms * 1e3:.2f} us/launch (bound "
          f"{entry['bound_ms'] * 1e3:.2f} us, {entry['bound_by']}), plain "
          f"{plain_ms:.3f} ms, torch.rand {lib_ms * 1e3:.2f} us | {card}",
          flush=True)
    return [entry]


def phase_reference(card):
    """The UNet's train forward + backward on the card against the CPU."""
    import torch
    from ust_run_tpu_torch.models import UNet

    net_cpu = UNet(3, 2).init_weights_(torch.Generator().manual_seed(1))
    net_gpu = UNet(3, 2).to("cuda").to(memory_format=torch.channels_last)
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
    fwd_err = (outs[0][0] - outs[1][0]).abs().max().item()
    # the out conv's gradients sit behind no ReLU or max-pool decision, so
    # float32 rounding cannot flip them (deeper gradients can jump at a
    # ReLU input within rounding of 0; the CPU tests pin those)
    grad_err = max(((outs[1][1][k] - outs[0][1][k]).abs().max()
                    / outs[0][1][k].abs().max().clamp_min(1e-12)).item()
                   for k in ("outc.conv.weight", "outc.conv.bias"))
    if not (fwd_err < 1e-3 and grad_err < 1e-3):
        fail(f"card vs CPU UNet: forward {fwd_err}, grads {grad_err}")
    print(f"[reference] UNet (6x64^2x3, 3 BN groups, f32, TF32 off) card "
          f"vs CPU: forward max |d| {fwd_err:.2e}, out-conv gradients max "
          f"|d|/max|g| {grad_err:.2e} | {card}", flush=True)


def phase_main_path(card, work, profile_out=None):
    import numpy as np
    import torch
    from ust_run_tpu_torch.config import build_parser, config_from_args
    from ust_run_tpu_torch.data.synthetic import generate
    from ust_run_tpu_torch.engine.trainer import Trainer
    from ust_run_tpu_torch.ops import augment, rng

    root = generate("fundus", os.path.join(work, "fundus"), n_train=8,
                    n_test=1, size=256, seed=0)
    # the bar of tests/test_ops.py:221 through the kernel: no augmentation
    # branch may blank out a bright sample
    img = torch.full((8, 256, 256, 3), 200, dtype=torch.uint8, device="cuda")
    lab = torch.full((8, 256, 256, 1), 128, dtype=torch.uint8,
                     device="cuda")
    out, _ = augment.weak_augment_batch(
        img, lab, size=256, fillcolor=255,
        generator=torch.Generator(device="cuda").manual_seed(11),
        host_generator=torch.Generator().manual_seed(12))
    black = (out < 1.0).float().mean(dim=(1, 2, 3)).max().item()
    if black >= 0.5:
        fail(f"weak augmentation blanked a sample ({black:.3f} black)")

    args = build_parser().parse_args([
        "--dataset", "fundus", "--data_root", root, "--lb_domain", "1",
        "--lb_num", "4", "--save_name", "smoke", "--overwrite",
        "--model_root", os.path.join(work, "model"), "--device", "cuda"])
    cfg = config_from_args(args).resolve()
    trainer = Trainer(cfg, os.path.join(work, "model"))
    p = cfg.profile()
    width = trainer.state.student.inc.double_conv[0].out_channels
    deepest = trainer.state.student.down4.maxpool_conv[1] \
        .double_conv[3].out_channels
    if (p.patch_size, p.num_channels, cfg.label_bs, cfg.unlabel_bs,
            width, deepest) != (256, 3, 4, 4, 64, 1024):
        fail("main path is not the full-width fundus configuration")

    rng.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = trainer.train_steps(WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # any host-device synchronisation inside the step raises here; the
    # trainer's metric fetch waits on a recorded event, which is not one
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics += trainer.train_steps(TIMED_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = rng.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    steps = WARMUP_STEPS + TIMED_STEPS
    if len(metrics) != steps:
        fail(f"{len(metrics)} metric rows for {steps} steps")
    for i, m in enumerate(metrics):
        for k in ("loss", "sup_loss", "unsup_loss_ul", "unsup_loss_lu",
                  "unsup_loss_s"):
            if not np.isfinite(float(m[k])):
                fail(f"step {i + 1}: {k} = {m[k]}")
    if launches != steps:
        fail(f"uniform_rng launched {launches} times in {steps} steps")
    imgs = TIMED_STEPS * (cfg.label_bs + cfg.unlabel_bs)
    step_ms = dt / TIMED_STEPS * 1e3
    last = metrics[-1]
    print(f"[main path] fundus UNet 64->1024, 3x256^2, batch 4+4, bf16 "
          f"autocast: {WARMUP_STEPS}+{TIMED_STEPS} steps, "
          f"{imgs / dt:.2f} img/s, {step_ms:.1f} ms/step, "
          f"peak {peak_gib:.2f} GiB; uniform_rng launches {launches}; no "
          f"host-device sync in the timed steps; last loss "
          f"{float(last['loss']):.4f} sup {float(last['sup_loss']):.4f} | "
          f"{card}", flush=True)
    if profile_out:
        phase_profile(card, trainer, step_ms, profile_out)
    return {"uniform_rng": launches}


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


def phase_profile(card, trainer, step_ms, out_path):
    """PROFILED_STEPS more steps of the main path's trainer under
    torch.profiler (CPU and CUDA activities)."""
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

    ops = sorted((e for e in prof.key_averages()
                  if e.device_type != cuda and device_us(e) > 0),
                 key=device_us, reverse=True)
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
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[profile] {n} steps: wall {summary['wall_ms_per_step']:.1f} "
          f"ms/step under the profiler ({step_ms:.1f} without), device "
          f"kernels {summary['device_kernel_ms_per_step']:.1f} ms/step, busy "
          f"{summary['device_busy_share']:.3f} "
          f"({summary['device_busy_share_unprofiled']:.3f} of the unprofiled "
          f"step), {summary['kernel_launches_per_step']:.0f} kernels/step, "
          f"sync calls " + ", ".join(f"{k} {len(v)}" for k, v in syncs.items())
          + f"; convs {gflop:.2f} GFLOP per image forward; -> {out_path} | "
          f"{card}", flush=True)


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="FILE", default=None,
                    help="also profile the main path; write JSON to FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA GPU")
    sys.path.insert(0, HERE)
    from ust_run_tpu_torch.engine.trainer import set_numerics
    from ust_run_tpu_torch.ops import cuda_build

    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    lib = cuda_build.build("uniform_rng")
    print(f"[build] {os.path.relpath(lib, HERE)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    set_numerics()
    kernels = phase_kernels(card)
    phase_reference(card)
    work = os.path.join(HERE, "_smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        launches = phase_main_path(card, work, args.profile)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                    "max_abs_err"):
            if k[key] is not None and not math.isfinite(k[key]):
                fail(f"{k['name']}: {key} = {k[key]}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
