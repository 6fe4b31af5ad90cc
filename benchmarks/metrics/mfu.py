"""The whole step's share of the card's peak: FLOPs a step
(benchmarks/counting.py, on the plain reference model) times the steps of
the traced run's unprofiled window, over its seconds, over the peak of
the configuration's compute dtype, in percent."""


def read(ctx):
    peaks = ctx["peaks"]
    if peaks is None or not ctx["timed_steps"]:
        return None
    peak = peaks[ctx["config"]["compute_dtype"]]
    rate = ctx["flops_per_step"] * ctx["timed_steps"] / ctx["timed_s"]
    return 100.0 * rate / peak
