"""The comparison that decides `correct`.

Both sides start from the same weights, corpus and index rows and take
the same first steps: the program through the cell's own call, the plain
reference (benchmarks/reference) one step at a time. The numbers compare
them, each by the reference:

  loss_gap       the largest |loss_p - loss_r| / |loss_r| over the steps;
  loss_gap_first the same of the first step alone;
  grad_gap       the first step's gradient of each student leaf as the
                 optimizer gets it (for the program its momentum buffer
                 after one step less the weight decay of the initial
                 weight): the largest | |g_p| - |g_r| | / max(|g_r|,
                 median leaf's |g_r|);
  grad_gap_median
                 the median over the leaves of the same gaps;
  grad_gap_step2 the same gradient gap of the second step: on the cell's
                 call the first replay of the captured step, the first
                 step being the capture's eager warm-up (for the program
                 the momentum after the step less 0.9 times the momentum
                 before it and the weight decay of the weight before it);
  grad_gap_step2_median
                 the median over the leaves of the second step's gaps;
  change_gap     the change of every state tensor after the checked steps
                 (both models' parameters and BatchNorm statistics, the
                 curriculum queue, the LQ carry, the threshold), by the
                 same measure, the largest over the leaves;
  change_gap_model
                 the same over both models' leaves alone;
  change_gap_params
                 the same over both models' weights alone (the student's
                 parameters and the teacher's EMA of them, without the
                 BatchNorm running statistics);
  change_gap_median
                 the median over the leaves of the same gaps.

A cell compares those its file's `limits` name. Leaves whose reference
gradient is under a thousandth of the median leaf's (a bias under
BatchNorm) move by rounding alone: they are left out of the gradient and
the change, by that rule and not by name. `nonfinite_steps` counts the
timed window's steps whose loss is not finite; its limit is 0.
"""

import math

import torch

ROUNDING_SHARE = 1e-3
NUMBERS = ("loss_gap", "loss_gap_first", "grad_gap", "grad_gap_median",
           "grad_gap_step2", "grad_gap_step2_median", "change_gap",
           "change_gap_model", "change_gap_params", "change_gap_median")
STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


def norms(tensors):
    """{leaf: float64 norm} of a dict of tensors."""
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def trajectory(losses, init, grads, final):
    """What one side's first steps give the comparison: the losses, each
    step's gradient norm of each student leaf (`grads`, a list of dicts,
    one a step), each state leaf's change norm."""
    return {"loss": [float(v) for v in losses],
            "grad": [norms(g) for g in grads],
            "change": {k: float(torch.linalg.vector_norm(
                final[k].detach().double()
                - init[k].detach().to(final[k].device).double()))
                for k in final}}


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def _gap(value, ref, base):
    """|value - ref| / base; a value that is not finite reads inf."""
    if not math.isfinite(value):
        return math.inf
    if base > 0:
        return abs(value - ref) / base
    return 0.0 if value == ref else math.inf


def _gaps(side, ref, keys):
    """{leaf: gap} of `keys`, each by max(its reference, the median
    leaf's reference)."""
    med = _median([ref[k] for k in keys])
    return {k: _gap(side[k], ref[k], max(ref[k], med)) for k in keys}


def _worst(gaps):
    leaf = max(gaps, key=gaps.get) if gaps else None
    return (gaps[leaf] if leaf else 0.0), leaf


def _rounding(grads):
    """The leaves whose reference gradient is under ROUNDING_SHARE of the
    median leaf's."""
    floor = ROUNDING_SHARE * _median(list(grads.values()))
    return {k for k, v in grads.items() if v < floor}


def _grad_gaps(side, ref):
    rounding = _rounding(ref)
    return _gaps(side, ref, [k for k in ref if k not in rounding])


def compare(side, ref):
    """Every number of NUMBERS (and the leaf the largest gaps were read
    on) of `side`'s trajectory against the reference's."""
    losses = [_gap(p, r, abs(r)) for p, r in zip(side["loss"], ref["loss"])]
    rounding = _rounding(ref["grad"][0])
    skip = {f"{m}.{k}" for k in rounding for m in ("student", "teacher")}
    steps = [_grad_gaps(p, r) for p, r in zip(side["grad"], ref["grad"])]
    grad_gap, grad_leaf = _worst(steps[0])
    second = steps[1] if len(steps) > 1 else {}
    change = _gaps(side["change"], ref["change"],
                   [k for k in ref["change"] if k not in skip])
    change_gap, change_leaf = _worst(change)
    model = {k: v for k, v in change.items()
             if k.startswith(("student.", "teacher."))}
    params = {k: v for k, v in model.items()
              if not k.endswith(STATISTICS)}
    return {"loss_gap": max(losses), "loss_gap_first": losses[0],
            "grad_gap": grad_gap,
            "grad_gap_median": _median(list(steps[0].values())),
            "grad_gap_step2": _worst(second)[0],
            "grad_gap_step2_median": _median(list(second.values())),
            "change_gap": change_gap,
            "change_gap_model": _worst(model)[0],
            "change_gap_params": _worst(params)[0],
            "change_gap_median": _median(list(change.values())),
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "rounding_leaves": len(rounding)}


def verdict(readings, nonfinite, limits):
    """(correct, {name: {"value", "limit"}}): every number `limits` names
    at or under its limit, and no step of the window with a non-finite
    loss."""
    out = {name: {"value": readings[name], "limit": limit}
           for name, limit in limits.items()}
    out["nonfinite_steps"] = {"value": nonfinite, "limit": 0}
    ok = all(v["limit"] is not None and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
