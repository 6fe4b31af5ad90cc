"""Share of the profiled call's wall time in which no kernel ran on the
card: 1 - (union of the kernels' intervals) / (host seconds between the
synchronises around the call), in percent."""


def read(ctx):
    w = ctx["window"]
    if w.kernels == 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.wall_s)
