"""The port's step-stage clock (ust_run_tpu_torch/utils/trace.py), read by
the `<stage>_ms_per_step` metrics (`inputs`, `teacher_fwd`,
`student_fwd`, `backward`, `update`): device time a step in each span,
along the cell's path. benchmarks/README.md, "The stage metrics", says
what it covers."""


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
