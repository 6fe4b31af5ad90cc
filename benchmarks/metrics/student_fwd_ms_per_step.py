"""Device milliseconds a step in the span `step.student_fwd` of the port's
stage clock: the student's 21-image forward and the CE+Dice terms
(loss_terms). Read over every step of the run on the cell's path
(benchmarks/stages.py)."""

from benchmarks.stages import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "step.student_fwd")
