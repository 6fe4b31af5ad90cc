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

Data parallel over N GPUs of a node, one process each (the global batch
stays `label_bs + unlabel_bs`; `--num_devices`, if given, must equal N):

    torchrun --nproc_per_node N -m ust_run_tpu_torch.train --dataset ...
"""

import sys

from ust_run_tpu_torch.cli import bootstrap
from ust_run_tpu_torch.config import build_parser
from ust_run_tpu_torch.engine.trainer import Trainer
from ust_run_tpu_torch.parallel import init_distributed
from ust_run_tpu_torch.utils.device import resolve_device


def main(argv=None):
    return launch(build_parser().parse_args(argv), __file__)


def launch(args, script_path):
    """`run` inside the process group that torchrun's environment asks
    for (none in a plain launch), torn down at the end."""
    resolve_device(args.device)          # raise before touching any file
    mesh = init_distributed(device=args.device)
    try:
        return run(args, script_path, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def run(args, script_path, mesh=None):
    """Train (or, with --eval, evaluate) from parsed flags on `mesh`
    (None: one process); returns the trainer."""
    cfg, snapshot_path = bootstrap(args, script_path, mesh)
    trainer = Trainer(cfg, snapshot_path, mesh)
    if cfg.eval:
        trainer.evaluate_and_checkpoint(-1, 0, save=False)
        trainer.close()
        return trainer
    trainer.train()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
