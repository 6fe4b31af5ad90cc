"""Device milliseconds a step in the span `step.backward` of the port's
stage clock: the backward pass (loss.backward()). Read over every step
of the run on the cell's path (benchmarks/stages.py)."""

from benchmarks.stages import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "step.backward")
