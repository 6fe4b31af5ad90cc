"""Operations and bytes of a step's attention, softmax(Q K^T / sqrt(d)) V,
in a configuration with a transformer encoder (`model.num_layers`,
`num_heads`, `head_size`, and the token grid of `patch` over
`patch_size`), for the `attention_roofline` metric.

A head of one image over n tokens of size d:
  forward   4 n^2 d FLOPs (Q K^T and P V, 2 FLOPs a multiply-add);
  backward  2.5 times that: a flash backward recomputes Q K^T and
            computes dV, dP, dQ and dK, five products;
  bytes     the forward reads Q, K, V and writes O and the row
            statistics; the backward adds dO, dQ, dK and dV: each tensor
            once, n d elements in the compute dtype, the statistics n
            float32.
A step runs the teacher's forward on 3 x unlabel_bs images and the
student's forward and backward on 4 x unlabel_bs + label_bs + 1.
"""

from benchmarks.counting import DTYPE_BYTES

BACKWARD_PER_FORWARD = 2.5


def shape(config):
    """(layers, heads, tokens, head size) of the configuration."""
    m = config["model"]
    tokens = (config["patch"] // m["patch_size"]) ** 2
    return m["num_layers"], m["num_heads"], tokens, m["head_size"]


def step_counts(config, cell):
    """(FLOPs, bytes) of one step's attention."""
    layers, heads, n, d = shape(config)
    teacher = 3 * cell["unlabel_bs"]
    student = 4 * cell["unlabel_bs"] + cell["label_bs"] + 1
    per_head = layers * heads
    fwd = 4 * n * n * d
    flops = per_head * fwd * (teacher + student * (1 + BACKWARD_PER_FORWARD))
    el = DTYPE_BYTES[config["compute_dtype"]] * n * d
    stats = 4 * n
    per_fwd = 4 * el + stats                    # Q, K, V, O, statistics
    per_bwd = 4 * el                            # dO, dQ, dK, dV
    nbytes = per_head * (teacher * per_fwd + student * (per_fwd + per_bwd))
    return flops, nbytes
