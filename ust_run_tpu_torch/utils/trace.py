"""Step-stage spans: named host ranges for torch.profiler, and a stage
clock on the device that runs inside a captured CUDA graph.

`span(name, device=None)` is a context manager that does two things:

  * Host range. Under a torch.profiler session it enters a host range
    named `name` (`_host_range`), so the trace names the host time, and
    the device's idle gaps under it, by the span. Without a session it
    checks that once and enters nothing. The range is a record function
    of the operators' scope: `torch.profiler.record_function`'s user
    scope would also put a device-side annotation of the span into the
    trace, as if it were a kernel as long as the span's device work.
  * Stage clock, for a span given a `device` (the names of `STAGES`). At
    each boundary a stamp goes on the device's current stream: on CUDA
    the single-thread kernel of csrc/stage_clock.cu, which adds the
    device time since the previous stamp to the innermost open span's
    slot of a small int64 accumulator and, at a span's exit, counts the
    span. Nested spans subtract out: each slot holds its span's self
    time. A stamp recorded into a CUDA graph capture is a node of the
    graph, so every replay adds its stage times on the device, with no
    host sync; such stamps go to the "graph" row of the accumulator,
    stamps that run eagerly to the "eager" row. On the CPU a plain clock
    (`cpu_clock`, time.perf_counter_ns) keeps the same accounting on the
    host, along the "eager" path.

The stamps write only the accumulator, so they change no result.
`stage_totals(device, path)` reads it (a copy to the host: not inside a
step); `reset()` zeroes it. What the port spans:

  step.inputs       build_inputs (self time: assembly, augmentation, FDA,
                    CutMix, pseudo-labels, ensemble, LQ composite)  clocked
  step.teacher_fwd  teacher_forward inside build_inputs             clocked
  step.student_fwd  loss_terms (the student's forward, CE+Dice)     clocked
  step.backward     loss.backward()                                 clocked
  step.update       apply_update (SGD, EMA, hardness, queue, LQ)    clocked
  call.feeds        draw_feed / draw_feeds (host RNG draws)        host only
  call.to_device    host_to_device (pinning and the copy)          host only
  call.replay       one replay of the captured step                host only
"""

import ctypes
import time

import torch

STAGES = ("step.inputs", "step.teacher_fwd", "step.student_fwd",
          "step.backward", "step.update")
PATHS = ("graph", "eager")
# A row of the accumulator: the clock at the row's last stamp, then the
# nanoseconds and the count of each stage.
_WIDTH = 1 + 2 * len(STAGES)
_SLOT = {name: i for i, name in enumerate(STAGES)}

cpu_clock = time.perf_counter_ns

_open = []          # the stage of each open clocked span, innermost last
_cpu_rows = [0] * _WIDTH
# The card's accumulator, (2, _WIDTH) int64, one row a path: (tensor, its
# address, the card's index). One card a process, as the port runs.
_acc = None
_cuda = None        # (the stamp's launch, raw current stream, capturing)
# torch's private entry points, checked on torch 2.11 (CUDA) and 2.13
# (CPU): the profiler's state and its operator-scope record function here,
# the raw stream and capture state in `_cuda_calls`.
_profiling = torch.autograd._profiler_enabled
_host_range = torch._C._profiler._RecordFunctionFast


def _cuda_calls():
    """The launch of csrc/stage_clock.cu (built at first use), and the
    current stream's raw handle and capture state as torch's C functions
    give them: torch.cuda.current_stream makes a Stream object a call,
    which is most of a stamp's host time."""
    global _cuda
    from ust_run_tpu_torch.ops import cuda_build
    fn = cuda_build.load("stage_clock").stage_clock_stamp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda = (fn, torch._C._cuda_getCurrentRawStream,
             torch._C._cuda_isCurrentStreamCapturing)
    return _cuda


def _accumulator(device):
    """The card's accumulator (`_acc`), made at first use on `device`."""
    global _acc
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the stage clock's accumulator is made outside "
                           "a CUDA graph capture: run a clocked span "
                           "eagerly on the device first")
    acc = torch.zeros((len(PATHS), _WIDTH), dtype=torch.int64,
                      device=device)
    _acc = (acc, acc.data_ptr(), acc.device.index)
    return _acc


def _stamp(device, add, count):
    """One stamp on `device`: the time since the row's last stamp added to
    slot `add` (-1: none) and slot `count` counted (-1: none)."""
    if device.type == "cpu":
        now = cpu_clock()
        row = _cpu_rows
        if add > 0:
            row[add] += now - row[0]
        if count > 0:
            row[count] += 1
        row[0] = now
        return
    launch, raw_stream, capturing = _cuda or _cuda_calls()
    _, base, index = _acc or _accumulator(device)
    row = base if capturing() else base + 8 * _WIDTH
    err = launch(row, add, count, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"stage_clock_stamp failed: CUDA error {err}")


class span:
    """A named span of the step (see the module's docstring): a host range
    under torch.profiler and, with `device`, a stage of the clock."""

    __slots__ = ("name", "device", "stage", "_range")

    def __init__(self, name, device=None):
        self.name, self.device = name, device
        self.stage = None if device is None else _SLOT[name]

    def __enter__(self):
        self._range = None
        if _profiling():
            self._range = _host_range(self.name)
            self._range.__enter__()
        if self.stage is not None:
            _stamp(self.device, 1 + 2 * _open[-1] if _open else -1, -1)
            _open.append(self.stage)
        return self

    def __exit__(self, kind, value, tb):
        if self.stage is not None:
            _open.pop()
            if kind is None:     # after an error (a failed capture), no stamp
                s = self.stage
                _stamp(self.device, 1 + 2 * s, 2 + 2 * s)
        if self._range is not None:
            self._range.__exit__(kind, value, tb)
        return False


def stage_totals(device, path):
    """{stage: (count, seconds)} of every stage in `STAGES`, stamped on
    `device` along `path` ("graph": launches recorded into a capture, run
    by its replays; "eager": the rest) since the process started or the
    last `reset()`. On CUDA (the process's one card) this waits for the
    card and copies the accumulator to the host."""
    if path not in PATHS:
        raise ValueError(f"path is one of {PATHS}, got {path!r}")
    if torch.device(device).type == "cpu":
        row = _cpu_rows if path == "eager" else [0] * _WIDTH
    elif _acc is not None:
        torch.cuda.synchronize(_acc[0].device)
        row = _acc[0][PATHS.index(path)].tolist()
    else:
        row = [0] * _WIDTH
    return {name: (row[2 + 2 * i], row[1 + 2 * i] / 1e9)
            for i, name in enumerate(STAGES)}


def reset():
    """Zero the stage clock, on the host and on the card."""
    _cpu_rows[:] = [0] * _WIDTH
    if _acc is not None:
        _acc[0].zero_()
