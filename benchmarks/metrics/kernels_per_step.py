"""Device kernels a step in the profiled call: an exact count that drops
when passes are fused."""


def read(ctx):
    w = ctx["window"]
    return w.kernels / w.steps if w.kernels else None
