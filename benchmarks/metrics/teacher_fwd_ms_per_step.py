"""Device milliseconds a step in the span `step.teacher_fwd` of the port's
stage clock: the teacher's 3-group forward (teacher_forward inside
build_inputs). Read over every step of the run on the cell's path
(benchmarks/stages.py)."""

from benchmarks.stages import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "step.teacher_fwd")
