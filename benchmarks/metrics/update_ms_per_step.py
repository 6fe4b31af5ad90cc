"""Device milliseconds a step in the span `step.update` of the port's stage
clock: apply_update: SGD, EMA, hardness, the curriculum queue, the LQ
carry and the packed metrics. Read over every step of the run on the
cell's path (benchmarks/stages.py)."""

from benchmarks.stages import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "step.update")
