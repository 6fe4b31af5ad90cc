"""Device milliseconds a step outside the convolution operators
(elementwise passes, GroupedBatchNorm, the data ops, the losses, SGD and
EMA), from the same eager profile as conv_ms_per_step."""


def read(ctx):
    ops = ctx["ops"]
    if not ops.kernel_s:
        return None
    return 1e3 * (ops.kernel_s - (ops.conv_s or 0.0)) / ops.steps
