"""Device milliseconds a step in the port's model span `model.vit`:
TransUNet's encoder forward, from the patch embedding through
`encoder_norm`, in the teacher's and the student's forward (its self
time, taken out of `step.teacher_fwd` and `step.student_fwd`). Its
seconds along the cell's path over the steps (`step.update`'s count),
not over the span's own count (two a step). None where the program has
no such span (benchmarks/stages.py)."""

SPAN = "model.vit"


def read(ctx):
    import torch
    if not torch.cuda.is_available():
        return None
    try:
        from ust_run_tpu_torch.utils import trace
    except ImportError:
        return None
    if SPAN not in getattr(trace, "MODEL_SPANS", ()):
        return None
    totals = trace.stage_totals(torch.device("cuda", 0), ctx["cell"]["call"],
                                ("step.update", SPAN))
    steps, (count, seconds) = totals["step.update"][0], totals[SPAN]
    return 1e3 * seconds / steps if steps and count else None
