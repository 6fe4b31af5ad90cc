"""ust_run_tpu_torch.engine.checkpoint and the trainer's resume, on the CPU:

  * the port's best-model file (a bare torch state_dict, upstream's
    format) is read unchanged by the JAX package's
    `checkpoint.load_best_model`, and the JAX UNet's eval-mode forward with
    those variables equals the port's (float32, 1e-5);
  * a run saved at step k and resumed with --load takes step k+1
    bit-equal to an unbroken run: weights, BN statistics, SGD momentum,
    both generators, the samplers, the curriculum queue, the LQ carry and
    choice_th are all restored;
  * writes leave no temp file behind, and a checkpoint of another shape
    raises a readable error.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ust_run_tpu.engine import checkpoint as jax_ckpt
from ust_run_tpu.models import UNet as JaxUNet
from ust_run_tpu_torch.config import build_parser, config_from_args
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.engine import checkpoint as ckpt
from ust_run_tpu_torch.engine.trainer import Trainer
from ust_run_tpu_torch.models import UNet

SIZE = 32


def _random_unet(channels, classes, seed):
    """A port UNet with torch-default weights and random BN statistics
    and affines (so eval mode is not the identity)."""
    g = torch.Generator().manual_seed(seed)
    net = UNet(channels, classes).init_weights_(g)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith(("running_var", "weight")) and t.ndim == 1:
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith(("running_mean", "bias")) and t.ndim == 1:
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return net.eval()


def test_jax_reads_port_best_model(tmp_path):
    net = _random_unet(3, 2, seed=5)
    path = str(tmp_path / "unet_avg_dice_best_model.pth")
    ckpt.atomic_save(path, ckpt.host_copy(net.state_dict()))
    assert os.listdir(tmp_path) == ["unet_avg_dice_best_model.pth"]

    variables = jax_ckpt.load_best_model(path)
    x = np.random.RandomState(0).uniform(-1, 1, (2, SIZE, SIZE, 3)) \
        .astype(np.float32)
    want = JaxUNet(n_channels=3, n_classes=2).apply(
        variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    # the port reads its own file and an upstream-style full checkpoint
    back = UNet(3, 2)
    ckpt.restore_onto(back, ckpt.load_best_model(path))
    full = str(tmp_path / "checkpoint.pth")
    ckpt.atomic_save(full, {"state_dict": net.state_dict(), "epoch": 3})
    sd = ckpt.load_best_model(full)
    for k, v in net.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)
        assert torch.equal(sd[k], v)


def _trainer(root, model_root, load=False, patch=SIZE):
    argv = ["--dataset", "fundus", "--data_root", root, "--lb_domain", "1",
            "--lb_num", "3", "--save_name", "r", "--max_iterations", "6",
            "--num_eval_iter", "2", "--patch_override", str(patch),
            "--eval_batch", "2", "--model_root", model_root,
            "--device", "cpu"] + (["--load"] if load else [])
    cfg = config_from_args(build_parser().parse_args(argv)).resolve()
    snap = os.path.join(model_root, "fundus", "r")
    os.makedirs(snap, exist_ok=True)
    return Trainer(cfg, snap)


def _state_tensors(t):
    s = t.state
    out = {f"stu.{k}": v for k, v in s.student.state_dict().items()}
    out.update({f"tea.{k}": v for k, v in s.teacher.state_dict().items()})
    out.update({f"momentum.{i}": st["momentum_buffer"] for i, st in
                s.optimizer.state_dict()["state"].items()})
    out.update({f"queue.{k}": v for k, v in s.queue.fields().items()})
    out.update({"lq.img": s.lq.img, "lq.pl": s.lq.pl, "lq.conf": s.lq.conf,
                "lq.valid": s.lq.valid, "choice_th": s.choice_th,
                "gen": s.generator.get_state(),
                "host_gen": s.host_generator.get_state()})
    return out


def test_resume_is_bit_equal(tmp_path):
    root = generate("fundus", str(tmp_path / "data"), n_train=6, n_test=2,
                    size=SIZE, seed=0)
    a = _trainer(root, str(tmp_path / "a"))
    a.train_steps(2)
    a.evaluate_and_checkpoint(0, a.iter_num)
    a.wait_for_checkpoint()
    snap_a = os.path.join(str(tmp_path / "a"), "fundus", "r")
    assert sorted(os.listdir(snap_a)) == [
        "checkpoint.pth", "log", "unet_avg_dice_best_model.pth"]
    snap_b = os.path.join(str(tmp_path / "b"), "fundus", "r")
    os.makedirs(snap_b)
    shutil.copy(os.path.join(snap_a, "checkpoint.pth"), snap_b)

    payload = ckpt.load_checkpoint(os.path.join(snap_b, "checkpoint.pth"))
    assert payload["epoch"] == 1 and payload["step"] == 2
    assert set(payload) >= {"state_dict", "ema_state_dict", "epoch"}

    b = _trainer(root, str(tmp_path / "b"), load=True)
    assert (b.start_epoch, b.iter_num) == (1, 2)
    assert b.stu_best_avg_dice == a.stu_best_avg_dice > 0
    a.new_epoch(1)
    ma, mb = a.train_steps(1), b.train_steps(1)
    assert a.state.step == b.state.step == 3
    for k in ma[0]:
        np.testing.assert_array_equal(ma[0][k], mb[0][k])
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    a.close()
    b.close()


def test_mismatched_checkpoint_raises(tmp_path):
    root = generate("fundus", str(tmp_path / "data"), n_train=6, n_test=1,
                    size=48, seed=0)
    a = _trainer(root, str(tmp_path / "m"))
    a.evaluate_and_checkpoint(0, 0)
    a.close()
    with pytest.raises(ValueError, match="incompatible.*queue"):
        _trainer(root, str(tmp_path / "m"), load=True, patch=48)
    with pytest.raises(ValueError, match="incompatible.*shape"):
        ckpt.restore_onto(UNet(1, 2), UNet(3, 2).state_dict())
