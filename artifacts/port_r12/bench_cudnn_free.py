"""`python -m ust_run_tpu_torch.bench` with the change's code but cuDNN
as the parent left it (cudnn.deterministic and cudnn.benchmark both off:
cuDNN's heuristic choice, deterministic or not), to split a slowdown of
`--deterministic 1` between cuDNN's deterministic algorithms and the rest
of the change. Run from the root of a checkout:

    UST_BENCH_MODEL=deeplabv2_r50 python artifacts/port_r12/bench_cudnn_free.py
"""

import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from ust_run_tpu_torch import bench  # noqa: E402


def cudnn_free(deterministic=1, seed=None):
    real(deterministic, seed)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False


real = bench.set_numerics
bench.set_numerics = cudnn_free

if __name__ == "__main__":
    bench.main()
