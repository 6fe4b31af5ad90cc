"""M&Ms (4-vendor cardiac, 4 classes) training entry point of the port
(counterpart of the repo's train_mnms.py; reference train_mnms.py:38-78).

    python -m ust_run_tpu_torch.train_mnms --data_root DIR --lb_num 20 \
        --save_name run1 --device cuda

The flags of the port's train entry with `--dataset` fixed to MNMS (the
288 px, 3-part profile); the same trainer, `--eval` and `--load`.
"""

import sys

from ust_run_tpu_torch.config import build_parser
from ust_run_tpu_torch.train import run


def main(argv=None):
    args = build_parser(mnms=True).parse_args(argv)
    args.dataset = "MNMS"
    return run(args, __file__)


if __name__ == "__main__":
    main(sys.argv[1:])
