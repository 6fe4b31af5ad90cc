"""The attention kernels' share of their roofline: the least time the
card needs for a step's attention (benchmarks/attention.py: FLOPs over
the compute dtype's peak, or bytes over the HBM bandwidth, whichever is
larger) over their device time a step (attention_ms_per_step), in
percent."""

from benchmarks import attention, registry


def read(ctx):
    peaks = ctx["peaks"]
    measured = registry.reader("attention_ms_per_step")(ctx)
    if peaks is None or measured is None:
        return None
    flops, nbytes = attention.step_counts(ctx["config"], ctx["cell"])
    bound = max(flops / peaks[ctx["config"]["compute_dtype"]],
                nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / (measured / 1e3)
