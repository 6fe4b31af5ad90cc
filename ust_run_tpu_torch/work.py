"""Alias of the port's train entry (counterpart of the repo's work.py:
upstream's README advertises `python work.py ...`, README.md:29).

    python -m ust_run_tpu_torch.work --dataset fundus ...
"""

import sys

from ust_run_tpu_torch.train import main

if __name__ == "__main__":
    main(sys.argv[1:])
