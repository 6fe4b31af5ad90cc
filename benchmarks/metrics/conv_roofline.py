"""The convolutions' share of their roofline: the least time the card
needs for a step's convolutions (FLOPs over the compute dtype's peak, or
bytes read and written once over the HBM bandwidth, whichever is larger)
over their measured device time a step (conv_ms_per_step), in percent."""


def read(ctx):
    ops, peaks = ctx["ops"], ctx["peaks"]
    if peaks is None or not ops.conv_s:
        return None
    bound = max(ctx["conv_flops_per_step"]
                / peaks[ctx["config"]["compute_dtype"]],
                ctx["conv_bytes_per_step"] / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / (ops.conv_s / ops.steps)
