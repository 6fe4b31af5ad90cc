"""Device milliseconds a step under the convolution operators (forward and
both gradients, each with every kernel it launched), from the profiler's
per-operator times over eager steps: a captured graph's trace attributes
no operator."""


def read(ctx):
    ops = ctx["ops"]
    return 1e3 * ops.conv_s / ops.steps if ops.conv_s else None
