"""Device milliseconds a step in the span `step.inputs` of the port's stage
clock: build_inputs' own time (batch assembly, weak and strong
augmentation, FDA, CutMix, pseudo-labels, the ensemble, the LQ
composite), the teacher's forward left out. Read over every step of the
run on the cell's path (benchmarks/stages.py)."""

from benchmarks.stages import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "step.inputs")
