"""`python -m ust_run_tpu_torch.test` on a best model that the JAX package
wrote (`ust_run_tpu.engine.checkpoint.save_best_model`: a pickle of
{"params", "batch_stats"} numpy trees), for the UNet and for
deeplabv2_r50, on the CPU, float32:

  * the port's `load_best_model` tells the pickle from a torch file by its
    first bytes, unpickles it without jax, flax or ust_run_tpu (checked in
    a subprocess with those blocked) and converts it for `--model`;
  * the test entry's dice equals the JAX evaluator's on the same weights
    and test images, per part, to 1e-6;
  * the JAX rolling checkpoint (a pickled JAX TrainState) gets a clear
    ValueError.

The profile's patch is cut to 64 pixels in both packages (the test entry
has no --patch_override), so that both evaluations stay small.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import init_fn, random_variables
from ust_run_tpu import config as jax_config
from ust_run_tpu.data.datasets import SegmentationDataset as JaxDataset
from ust_run_tpu.data.pipeline import TestLoader as JaxLoader
from ust_run_tpu.engine import checkpoint as jax_ckpt
from ust_run_tpu.engine.evaluator import Evaluator as JaxEvaluator
from ust_run_tpu.engine.trainer import build_model as jax_build_model
from ust_run_tpu.semisup import HyperParams as JaxHP
from ust_run_tpu_torch import config
from ust_run_tpu_torch import test as test_entry
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.engine import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64


@pytest.fixture
def small_fundus(monkeypatch):
    for module in (config, jax_config):
        p = module.PROFILES["fundus"]
        monkeypatch.setitem(module.PROFILES, "fundus", dataclasses.replace(
            p, patch_size=SIZE, load_size=SIZE if p.load_size else None))


@pytest.mark.parametrize("model", ["unet", "deeplabv2_r50"])
def test_test_entry_evaluates_a_jax_best_model(model, tmp_path,
                                               small_fundus):
    root = generate("fundus", str(tmp_path / "data"), n_train=2, n_test=2,
                    size=SIZE, seed=0)
    jcfg = jax_config.TrainConfig(dataset="fundus", model=model, amp=0,
                                  data_root=root, domain_num=2,
                                  eval_batch=2).resolve()
    jmodel = jax_build_model(jcfg)
    variables = random_variables(init_fn(
        jmodel, np.zeros((1, SIZE, SIZE, 3), np.float32), train=False),
        seed=3)
    snap = tmp_path / "m" / "fundus" / "j"
    snap.mkdir(parents=True)
    best = str(snap / f"{model}_avg_dice_best_model.pth")
    jax_ckpt.save_best_model(best, variables["params"],
                             variables["batch_stats"])

    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "ust_run_tpu"):
    sys.modules[name] = None
from ust_run_tpu_torch.engine import checkpoint
print(len(checkpoint.load_best_model({best!r}, {model!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == len(ckpt.load_best_model(best, model)) > 100

    dice = test_entry.main(["--dataset", "fundus", "--model", model,
                            "--data_root", root, "--save_name", "j",
                            "--model_root", str(tmp_path / "m"),
                            "--domain_num", "2", "--eval_batch", "2",
                            "--device", "cpu"])
    jp = jcfg.profile()
    loaders = [JaxLoader(JaxDataset("fundus", jp, root, "test", -1, [d]), 2)
               for d in (1, 2)]
    want = JaxEvaluator(jmodel, JaxHP.from_config(jcfg), loaders,
                        list(jp.parts)).run(variables["params"],
                                            variables["batch_stats"], 1)
    np.testing.assert_allclose(dice, want, rtol=0, atol=1e-6)


def test_jax_rolling_checkpoint_is_refused(tmp_path):
    from ust_run_tpu.models import UNet as JaxUNet
    from ust_run_tpu.semisup import create_train_state
    cfg = jax_config.TrainConfig(dataset="fundus", patch_override=32,
                                 amp=0).resolve()
    state = create_train_state(JaxUNet(n_channels=3, n_classes=2),
                               JaxHP.from_config(cfg), 0)
    path = str(tmp_path / "checkpoint.pth")
    jax_ckpt.save_checkpoint(path, state, 1, 0.5, 10, 0.4, 10)
    with pytest.raises(ValueError, match="JAX TrainState"):
        ckpt.load_best_model(path)
