"""The port's per-stage timing entry (ust_run_tpu_torch/perf_breakdown.py)
against the repo's tools/perf_breakdown.py: the JAX tool's keys in its
order, and the student stage's loss held against the JAX tool's loss_fn
(tools/perf_breakdown.py:124-137) on the same inputs, the JAX UNet
carrying the port UNet's weights across convert.py, float32 on the CPU at
patch 32."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import unet_pair
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.utils import losses as JL
from ust_run_tpu_torch import perf_breakdown as pb
from ust_run_tpu_torch.config import TrainConfig
from ust_run_tpu_torch.semisup.step import HyperParams

pytestmark = pytest.mark.usefixtures("single_thread")

# the bar of the step's losses against the JAX step (tests/test_torch_step.py;
# this loss reads within 1e-6 on the CPU)
LOSS_RTOL = 1e-5
# tools/perf_breakdown.py's keys, in its order
KEYS = ["weak_aug_8img", "strong_aug_4img", "fda_4img", "cutmix_boxes",
        "teacher_fwd_12img", "student_grad_21img", "optimizer_ema",
        "full_step", "stage_sum"]


@pytest.mark.parametrize("skip_full", [False, True])
def test_output_has_the_jax_tools_keys(skip_full, capsys, monkeypatch):
    monkeypatch.setattr(pb, "TrainConfig", lambda dataset: TrainConfig(
        dataset=dataset, patch_override=32))
    argv = ["--n", "1", "--device", "cpu"] + (["--skip-full"] if skip_full
                                             else [])
    pb.main(argv)
    out = json.loads(capsys.readouterr().out)
    want = [k for k in KEYS if not (skip_full and k == "full_step")]
    assert list(out) == want
    assert all(math.isfinite(v) and v > 0 for v in out.values())
    stages = [v for k, v in out.items() if k not in ("full_step",
                                                     "stage_sum")]
    assert out["stage_sum"] == pytest.approx(sum(stages), abs=0.05)


@pytest.mark.parametrize("dataset", ["fundus", "BUSI"])
def test_student_loss_matches_the_jax_tool(dataset):
    cfg = TrainConfig(dataset=dataset, patch_override=32).resolve()
    hp = HyperParams.from_config(cfg)
    s, c, nc = hp.patch, hp.channels, hp.num_classes
    x = pb.synthetic_inputs(hp, 1, torch.device("cpu"),
                            np.random.RandomState(0))
    model, variables, net = unet_pair(c, nc, 1, 1, s, seed=3)
    stu_in = torch.cat([x["x20"], x["x1"]])
    got = pb.student_loss(net.train(), stu_in, x["pl2"], x["mask2"], hp)

    # the JAX tool's inputs (tools/perf_breakdown.py:81-95) and loss_fn
    rng = np.random.RandomState(0)
    rng.randint(0, 256, (8, s, s, c))
    rng.choice([0, 128, 255], (8, s, s, 1))
    x12 = jnp.asarray(rng.randn(12, s, s, c), jnp.float32)
    x20 = jnp.asarray(rng.randn(20, s, s, c), jnp.float32)
    x1 = x12[:1]
    if hp.multilabel:
        pl2 = jnp.asarray(rng.rand(4, s, s, nc) > 0.5, jnp.float32)
        mask2 = jnp.ones((4, s, s, nc), jnp.float32)
    else:
        pl2 = jnp.asarray(rng.randint(0, nc, (4, s, s)), jnp.int32)
        mask2 = jnp.ones((4, s, s, 1), jnp.float32)

    def loss_fn(params, bs, x20, x1):
        logits, _ = model.apply(
            {"params": params, "batch_stats": bs},
            jnp.concatenate([x20, x1]), train=True,
            group_sizes=(4, 4, 4, 4, 4, 1),
            group_valid=jnp.ones((6,), jnp.bool_),
            mutable=["batch_stats"])
        parts = jnp.split(logits, [4, 8, 12, 16, 20])
        total = 0.0
        for lg in parts[1:5]:
            total += JL.ce_plus_dice(lg, pl2, multilabel=hp.multilabel,
                                     n_classes=nc, mask=mask2)
        return total + 0.0 * jnp.sum(parts[5])

    want = jax.jit(loss_fn)(variables["params"], variables["batch_stats"],
                            x20, x1)
    got = got.item()
    assert math.isfinite(got)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
