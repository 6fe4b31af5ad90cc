"""GroupedBatchNorm's share of an eager training step's device time, from
torch.profiler's events, for any tree of the repo (run on a card):

    python artifacts/port_r16/bn_share.py TREE MODEL [STEPS]

TREE's `ust_run_tpu_torch` goes first on the path; MODEL is `unet` or
`deeplabv2` (R101). `ust_run_tpu_torch.bench`'s state and corpus at its
defaults (fundus, batch 4+4) run 3 eager steps, then STEPS (default 3)
under the profiler. Each GroupedBatchNorm call, and each nn.ReLU module
call (the UNet's, before their fusion into the layer), is wrapped by
forward hooks in a `gbn` range. Attributed to the layer:
  * forward: every kernel launched inside a `gbn` range;
  * backward: every kernel launched inside an autograd node whose
    sequence number is that of an operator recorded in a `gbn` range, or
    inside the layer's own node (`_GroupedBNBackward`), counted once
    where nodes nest.
The ResNet's ReLUs are F.relu calls, not modules: before the fusion they
fall outside the ranges, after it they run inside the layer. Prints one
JSON line: ms a step of all kernels (copies and fills left out), of the
layer forward and backward, and the shares, with the kernel names that
take the layer's time.
"""

import collections
import json
import os
import sys


def main():
    tree, model = os.path.abspath(sys.argv[1]), sys.argv[2]
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    sys.path.insert(0, tree)
    os.environ["UST_BENCH_UNROLL"] = "1"
    os.environ["UST_BENCH_MODEL"] = model
    import torch
    from torch import nn
    from torch.profiler import ProfilerActivity, profile, record_function

    from ust_run_tpu_torch import bench as bench_mod
    from ust_run_tpu_torch.models.layers import GroupedBatchNorm
    assert bench_mod.__file__.startswith(tree), bench_mod.__file__

    cfg, _ = bench_mod.bench_config(os.environ)
    bench = bench_mod.Bench(cfg, "cuda")
    open_ranges = {}

    def enter(mod, args):
        r = record_function("gbn")
        r.__enter__()
        open_ranges.setdefault(id(mod), []).append(r)

    def leave(mod, args, out):
        open_ranges[id(mod)].pop().__exit__(None, None, None)

    for net in (bench.state.student, bench.state.teacher):
        for mod in net.modules():
            if isinstance(mod, (GroupedBatchNorm, nn.ReLU)):
                mod.register_forward_pre_hook(enter)
                mod.register_forward_hook(leave)
    bench.calls(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bench.calls(steps)
        torch.cuda.synchronize()
    events = prof.events()

    def kernels(evt):        # copies and fills are no kernel of the step's
        return [k for k in evt.kernels
                if not k.name.startswith(("Memcpy", "Memset"))]

    ranges = [e for e in events if e.name == "gbn"]
    seqs = set()
    stack = list(ranges)
    while stack:
        e = stack.pop()
        if e.sequence_nr >= 0:
            seqs.add(e.sequence_nr)
        stack.extend(e.cpu_children)
    bwd_roots = [e for e in events
                 if e.name.startswith("autograd::engine::evaluate_function")
                 and (e.sequence_nr in seqs or "_GroupedBNBackward"
                      in e.name)]
    roots = set(e.id for e in bwd_roots)

    def nested_in_root(e):
        p = e.cpu_parent
        while p is not None:
            if p.id in roots:
                return True
            p = p.cpu_parent
        return False

    bwd_roots = [e for e in bwd_roots if not nested_in_root(e)]

    def subtree(e):
        out, stack = [], [e]
        while stack:
            x = stack.pop()
            out.append(x)
            stack.extend(x.cpu_children)
        return out

    names = collections.Counter()
    fwd_us = bwd_us = 0.0
    for e in ranges:
        if e.cpu_parent is not None and any(
                p.name == "gbn" for p in _ancestors(e)):
            continue
        for x in subtree(e):
            for k in kernels(x):
                fwd_us += k.duration
                names[k.name[:110]] += k.duration
    for e in bwd_roots:
        for x in subtree(e):
            for k in kernels(x):
                bwd_us += k.duration
                names[k.name[:110]] += k.duration
    cuda = torch.autograd.DeviceType.CUDA
    total_us = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == cuda and e.name != "gbn"
                   and not e.name.startswith(("Memcpy", "Memset")))
    print(json.dumps({
        "tree": tree, "model": model, "steps": steps,
        "card": torch.cuda.get_device_name(0),
        "kernel_ms_per_step": total_us / steps / 1e3,
        "gbn_fwd_ms_per_step": fwd_us / steps / 1e3,
        "gbn_bwd_ms_per_step": bwd_us / steps / 1e3,
        "gbn_share": (fwd_us + bwd_us) / total_us,
        "gbn_calls_per_step": len(ranges) / steps,
        "top_gbn_kernels_ms_per_step": [
            (n, round(us / steps / 1e3, 3))
            for n, us in names.most_common(12)]}), flush=True)


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


if __name__ == "__main__":
    main()
