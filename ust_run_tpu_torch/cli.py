"""CLI bootstrap (port of ust_run_tpu/cli.py without the JAX set-up).

Snapshot directory `<model_root>/<dataset>/<save_name>/` with the
overwrite guard, the entry script copied into it, and logging to
`log.txt` + stdout (reference train.py:964-999). The trainer's
generators are made from `--seed`; `--deterministic 1` (the default) also
seeds the global `random` and `np.random` as the JAX CLI does and makes
cuDNN deterministic (engine.trainer.set_numerics).
Under a data-parallel mesh every rank checks the guard and rank 0 alone
makes the directory, copies the script and logs.
"""

import logging
import os
import shutil
import sys

from ust_run_tpu_torch.config import config_from_args
from ust_run_tpu_torch.engine.trainer import set_numerics


def bootstrap(args, script_path, mesh=None):
    cfg = config_from_args(args).resolve()
    set_numerics(cfg.deterministic, cfg.seed)
    snapshot_path = os.path.join(cfg.model_root, cfg.dataset,
                                 cfg.save_name) + "/"
    exists = os.path.exists(snapshot_path)
    if mesh is not None:    # every rank looks before rank 0 makes it
        exists = mesh.any(exists)
    if exists and not cfg.overwrite and not cfg.load:
        raise Exception(f"file {snapshot_path} is exist!")
    if mesh is not None and mesh.rank != 0:
        return cfg, snapshot_path
    os.makedirs(snapshot_path, exist_ok=True)
    if os.path.exists(snapshot_path + "/code"):     # ust_run_tpu/cli.py:77
        shutil.rmtree(snapshot_path + "/code")
    try:
        shutil.copy(script_path, os.path.join(
            snapshot_path, os.path.basename(script_path)))
    except (shutil.SameFileError, FileNotFoundError):
        pass
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    log_file = logging.FileHandler(snapshot_path + "/log.txt")
    log_file.setFormatter(logging.Formatter(
        "[%(asctime)s.%(msecs)03d] %(message)s", datefmt="%H:%M:%S"))
    root.addHandler(log_file)
    root.addHandler(logging.StreamHandler(sys.stdout))
    logging.info(" ".join(["python"] + sys.argv))
    logging.info(str(args))
    return cfg, snapshot_path
