"""The port's step-stage clock (ust_run_tpu_torch/utils/trace.py), read by
the `<stage>_ms_per_step` metrics (`inputs`, `teacher_fwd`,
`student_fwd`, `backward`, `update`; with `.eager` in the eager cell).

A stamp kernel at each boundary of the step's spans adds up the device
time of the innermost open span on the card, inside the captured CUDA
graph too, and counts each span. A metric is that time over the count,
along the cell's path (`graph`: every replay of the captured step, from
the checked steps through the warm-up, the timed window and the profiled
calls; `eager`: the steps run eagerly, the checked steps included). It
covers every step of the run so far, not only the profiled call; the
trace's eager steps of a graph cell go to the eager path and are not in
it. A program without the clock reports none of these metrics."""


def ms_per_step(ctx, stage):
    """Device milliseconds a step in span `stage` on cuda:0 along the
    cell's call, or None where the program has no stage clock or the path
    has no stamps of the span."""
    import torch
    if not torch.cuda.is_available():
        return None
    try:
        from ust_run_tpu_torch.utils import trace
    except ImportError:
        return None
    count, seconds = trace.stage_totals(torch.device("cuda", 0),
                                        ctx["cell"]["call"]).get(
                                            stage, (0, 0.0))
    return 1e3 * seconds / count if count else None
