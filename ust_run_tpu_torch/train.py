"""Training entry point of the port (fundus / prostate / BUSI; MNMS has
`train_mnms`, and `work` is an alias of this one).

    python -m ust_run_tpu_torch.train --dataset fundus --data_root DIR \
        --lb_domain 1 --lb_num 20 --save_name run1 --device cuda

Flags are those of the JAX package's train.py (the port's own
`config.build_parser`) plus `--device` (default cuda; a missing card
raises unless `--device cpu` is given). `--model` is unet (default),
unet2d, deeplabv2 (ResNet-101) or deeplabv2_r50; a DeepLab backbone
starts from `<pretrained_root>/<arch>.pth` where the user has put that
file, else from its random init. `--eval` runs one evaluation of
the EMA and student models and saves nothing (train.py:17-20); `--load`
resumes from `<model_root>/<dataset>/<save_name>/checkpoint.pth`.
"""

import sys

from ust_run_tpu_torch.cli import bootstrap
from ust_run_tpu_torch.config import build_parser
from ust_run_tpu_torch.engine.trainer import Trainer
from ust_run_tpu_torch.utils.device import resolve_device


def main(argv=None):
    return run(build_parser().parse_args(argv), __file__)


def run(args, script_path):
    """Train (or, with --eval, evaluate) from parsed flags; returns the
    trainer."""
    resolve_device(args.device)          # raise before touching any file
    cfg, snapshot_path = bootstrap(args, script_path)
    trainer = Trainer(cfg, snapshot_path)
    if cfg.eval:
        trainer.evaluate_and_checkpoint(-1, 0, save=False)
        trainer.close()
        return trainer
    trainer.train()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
