"""Hyperparameter ramp schedules (port of ust_run_tpu/utils/ramps.py).

Host-side functions: the step count lives on the host in the port, so
the schedules are evaluated in numpy float32, the precision the JAX
step evaluates them in.
"""

import numpy as np


def sigmoid_rampup(current, rampup_length):
    """exp(-5 (1 - t)^2), t = clip(current/rampup_length, 0, 1)
    (reference utils/ramps.py:19-26). Returns np.float32."""
    if rampup_length == 0:
        return np.float32(1.0)
    current = np.clip(np.float32(current), np.float32(0.0),
                      np.float32(rampup_length))
    phase = np.float32(1.0) - current / np.float32(rampup_length)
    return np.float32(np.exp(np.float32(-5.0) * phase * phase))


def linear_rampup(current, rampup_length):
    """Linear 0->1 ramp (reference utils/ramps.py:29-35)."""
    if rampup_length < 0:
        raise ValueError(f"rampup_length {rampup_length} < 0")
    if rampup_length == 0 or current >= rampup_length:
        return 1.0
    return current / rampup_length


def cosine_rampdown(current, rampdown_length):
    """Cosine 1->0 rampdown (reference utils/ramps.py:38-41)."""
    return float(0.5 * (np.cos(np.pi * current / rampdown_length) + 1))


def consistency_weight(consistency, iter_num, max_iterations, rampup_length):
    """w = consistency * sigmoid_rampup(iter // (max_iter / rampup), rampup)
    (reference train.py:819-820): the float floor division makes a
    staircase schedule. Returns np.float32."""
    step = np.floor(np.float32(iter_num)
                    / np.float32(max_iterations / rampup_length))
    return np.float32(np.float32(consistency)
                      * sigmoid_rampup(step, rampup_length))
