"""Reduction of a torch.profiler window to the numbers the per-layer
metrics read. Nothing is written to disk: the events are reduced in
memory and only the summary is kept.

`profile(fn, steps)` runs `fn` between two synchronises under the
profiler (CPU and CUDA activities) and returns a `Summary`:
  wall_s        host seconds of the profiled window;
  busy_s        the union of the device kernels' intervals (seconds);
  kernels       device kernels in the window (copies and fills, which
                count as busy time, are not kernels);
  launch_api_s  host seconds in the runtime calls that launch kernels
                (names holding "LaunchKernel": cudaLaunchKernel,
                cuLaunchKernelEx, ...); a replay's cudaGraphLaunch is not
                counted, as it blocks while the device's queue is full;
  by_kernel     {kernel name: (count, seconds)};
  conv_s, kernel_s
                with `ops=True`: device seconds under the convolution
                operators (aten::convolution and aten::convolution_backward,
                each with every kernel it launched) and of all kernels;
  gaps          [(host activity, seconds)]: the idle gaps between kernels,
                each named by the innermost host event that spans its
                middle, summed by name.
"""

import dataclasses
import time

import numpy as np
import torch

CONV_OPS = ("aten::convolution", "aten::convolution_backward")
MAX_GAPS = 4000


@dataclasses.dataclass
class Summary:
    steps: int
    wall_s: float
    busy_s: float
    kernels: int
    launch_api_s: float
    by_kernel: dict
    gaps: list
    conv_s: float = None
    kernel_s: float = None


def _device_total(evt):
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _union_and_gaps(intervals):
    """(busy seconds, gaps as (start_us, end_us)) of sorted intervals."""
    busy, gaps = 0.0, []
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e6, gaps


def _name_gaps(gaps, host):
    """[(name, seconds)] of the longest gaps, named by the innermost host
    event spanning each gap's middle, summed by name, longest first."""
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:MAX_GAPS]
    if not host:
        return []
    starts = np.array([h[0] for h in host])
    ends = np.array([h[1] for h in host])
    dur = ends - starts
    totals = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        spans = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = host[spans[np.argmin(dur[spans])]][2] if len(spans) \
            else "(no host event)"
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
    return sorted(totals.items(), key=lambda kv: -kv[1])


def profile(fn, steps, ops=False):
    """`fn()` under the profiler; its `steps` steps are what per-step
    numbers divide by."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    device, host, launch_us, by_kernel, n_kernels = [], [], 0.0, {}, 0
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            device.append((s, t))
            n_kernels += not e.name.startswith(("Memcpy", "Memset"))
            n, sec = by_kernel.get(e.name, (0, 0.0))
            by_kernel[e.name] = (n + 1, sec + (t - s) / 1e6)
        else:
            host.append((s, t, e.name))
            if "LaunchKernel" in e.name:
                launch_us += t - s
    device.sort()
    busy, gaps = _union_and_gaps(device) if device else (0.0, [])
    out = Summary(steps=steps, wall_s=wall, busy_s=busy,
                  kernels=n_kernels, launch_api_s=launch_us / 1e6,
                  by_kernel=by_kernel, gaps=_name_gaps(gaps, host))
    if ops:
        avgs = {e.key: e for e in prof.key_averages()}
        out.conv_s = sum(_device_total(avgs[k]) for k in CONV_OPS
                         if k in avgs) / 1e6
        out.kernel_s = sum(sec for _, sec in by_kernel.values())
    return out


def breakdown(summary, top=10):
    """The result line's `breakdown`: the device operations that took
    most time and the longest idle gaps by host activity, seconds per
    step."""
    ops = sorted(summary.by_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    n = summary.steps
    return {"device_ops": [[name[:160], sec / n] for name, (_, sec) in ops],
            "idle_gaps": [[name[:160], sec / n]
                          for name, sec in summary.gaps[:top]]}
