"""The host's cost of one GroupedBatchNorm (+ReLU) call, forward and
backward, for any tree of the repo (run on a card):

    python artifacts/port_r16/host_us.py TREE fused|unfused

TREE's `ust_run_tpu_torch` goes first on the path. The layer runs on a
tiny bf16 channels_last input of the student's 6 groups (21 x 64 x 8 x 8),
so that the card finishes each kernel long before the host queues the
next: the least of 11 batches' wall µs a call over 100 back-to-back calls
(the card synchronised between batches only) is the host's cost. `fused`
passes relu=True to the layer; `unfused` applies F.relu after it (the
models before the fusion). Prints one JSON line.
"""

import json
import os
import sys
import time


def main():
    tree, mode = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F
    from ust_run_tpu_torch.models import layers
    assert layers.__file__.startswith(tree), layers.__file__

    sizes = (4, 4, 4, 4, 4, 1)
    bn = layers.GroupedBatchNorm(64).cuda()
    x = torch.randn((21, 64, 8, 8), device="cuda").to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last).requires_grad_()
    dy = torch.randn_like(x)

    def call():
        if mode == "fused":
            y = bn(x, group_sizes=sizes, relu=True)
        else:
            y = F.relu(bn(x, group_sizes=sizes))
        y.backward(dy)

    for _ in range(20):
        call()
    best = float("inf")
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            call()
        best = min(best, (time.perf_counter() - t0) / 100 * 1e6)
    torch.cuda.synchronize()
    print(json.dumps({"tree": tree, "mode": mode, "host_us_per_call": best,
                      "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
