"""The zoo through the port's training step and entries, on the CPU (and,
marked `cuda`, on a card):

  * one full UST-RUN step of `--model unet2d` against the JAX package's
    `make_step_parts`, fed the same draws as tests/test_torch_step.py
    feeds the UNet's: the JAX step's `build_inputs` and teacher input go
    through the port's teacher forward, `loss_terms`, backward and
    `apply_update`. Loss and terms at rtol 1e-5, gradients at rtol 1e-3 in
    norm (per tensor; a conv bias that a BatchNorm follows has a zero
    gradient but for rounding and is held at 1e-6 of the largest
    gradient's norm), new parameters, EMA parameters and BN statistics at
    1e-5. Fundus at epoch 0, from a seed at which no ReLU decision flips
    between the frameworks (gradients within 2e-5; at 5 of 8 seeds tried
    a flip moved some by 8e-4 to 4e-2; test_torch_step.py says why);
  * `Trainer` runs of `--model unet2d` and `--model deeplabv2_r50` on a
    synthetic prostate corpus with `--device cpu`: 2 steps, the epoch-end
    evaluation and checkpoint, a `--load` resume for 2 more steps, then
    the standalone evaluator with `--save_img`. A whole JAX step through
    ResNet-50 compiles too long for this tier (its own zoo step test is
    `slow`), so DeepLab's step is held by the module and gradient parity
    of test_torch_zoo.py and by this run;
  * `--model unet2d_dsbn` raises at Trainer construction;
  * the MNMS entry (`train_mnms`) and the `work` alias.
The file imports no JAX at the top (the parity test imports it), so its
card tests run where JAX is not installed:
`python -m pytest --noconftest -m cuda tests/test_torch_zoo_step.py`.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_threads import single_thread  # noqa: F401
from ust_run_tpu_torch import test as test_entry
from ust_run_tpu_torch import train, train_mnms, work
from ust_run_tpu_torch.config import build_parser, config_from_args
from ust_run_tpu_torch.convert import unet2d_state_dict_from_jax
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.engine.trainer import Trainer
from ust_run_tpu_torch.models import DeepLabV2, Unet2D
from ust_run_tpu_torch.ops import rng
from ust_run_tpu_torch.semisup import state as pstate
from ust_run_tpu_torch.semisup import step as pstep

pytestmark = pytest.mark.usefixtures("single_thread")

LOSSES = ("loss", "sup_loss", "unsup_loss_ul", "unsup_loss_lu",
          "unsup_loss_s")


def test_unet2d_step_matches_jax():
    import jax
    from test_torch_step import _Recorder, _assert_sd, _corpus, _hp, \
        _jax_state, _t
    from ust_run_tpu.models import Unet2D as JaxUnet2D
    from ust_run_tpu.semisup.step import make_step_parts

    jhp = _hp("fundus")
    hp = pstep.HyperParams(**dataclasses.asdict(jhp))
    r = np.random.RandomState(2)
    model = JaxUnet2D(c=jhp.channels, num_classes=jhp.num_classes)
    rec = _Recorder(model)
    _, build_inputs, loss_terms = make_step_parts(rec, jhp)
    step_fn, _, _ = make_step_parts(model, jhp)
    data = _corpus(jhp, r)
    idx = {"lb_idx": np.asarray([0, 3], np.int32),
           "ulb_idx": np.asarray([1, 4], np.int32)}
    js = _jax_state(jhp, model, r, 0, 0.1, 20)

    def sd(params, stats):
        return unet2d_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, params),
             "batch_stats": jax.tree.map(np.asarray, stats)})

    ps = pstate.create_train_state(
        hp, 0, "cpu", *(Unet2D(c=hp.channels, num_classes=hp.num_classes)
                        for _ in range(2)))
    ps.student.load_state_dict(sd(js.params, js.batch_stats))
    ps.teacher.load_state_dict(sd(js.ema_params, js.ema_batch_stats))
    ps.step, ps.epoch = int(js.step), int(js.epoch)
    ps.queue = pstate.CurriculumQueue(**{
        f.name: _t(getattr(js.queue, f.name))
        for f in dataclasses.fields(pstate.CurriculumQueue)})
    ps.lq = pstate.LQCarry(img=_t(js.lq.img), pl=_t(js.lq.pl),
                           conf=_t(js.lq.conf), valid=_t(js.lq.valid))
    ps.choice_th = _t(js.choice_th)

    inp, tea_in = jax.jit(
        lambda *a: (build_inputs(*a), rec.teacher_in))(js, data, idx)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        loss_terms, has_aux=True))(js.params, js, inp)
    new_js, _ = jax.jit(step_fn)(js, data, idx)

    pstep.teacher_forward(ps.teacher, _t(tea_in))
    pinp = {k: _t(v) for k, v in inp.items()
            if k not in ("rng_next", "tea_batch_stats", "cons_w")}
    pinp["cons_w"] = float(np.asarray(inp["cons_w"]))
    ps.optimizer.zero_grad()
    loss_t, aux_t = pstep.loss_terms(ps, pinp, hp)
    loss_t.backward()

    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for k in ("sup_loss", "unsup_ul", "unsup_lu", "unsup_s"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    g_sd = sd(grads_j, js.batch_stats)
    top = max(np.linalg.norm(g.numpy()) for g in g_sd.values())
    for name, p in ps.student.named_parameters():
        want = g_sd[name].numpy()
        if np.linalg.norm(want) < 1e-6 * top:
            # a conv bias that a BatchNorm follows: its gradient is zero
            # but for rounding, in both frameworks
            assert np.abs(p.grad.numpy()).max() < 1e-6 * top, name
            continue
        err = np.linalg.norm(p.grad.numpy() - want) / np.linalg.norm(want)
        assert err < 1e-3, (name, err)

    pinp["feed"] = pstep.unpack_feed(torch.from_numpy(
        pstep.pack_feed(hp, ps.step, ps.epoch)), hp)
    pstep.apply_update(ps, pinp, loss_t, aux_t, hp)
    tol = dict(rtol=1e-5, atol=1e-5)
    kinds = ("weight", "bias", "running_mean", "running_var")
    _assert_sd(ps.student.state_dict(),
               sd(new_js.params, new_js.batch_stats), kinds, **tol)
    _assert_sd(ps.teacher.state_dict(),
               sd(new_js.ema_params, new_js.ema_batch_stats), kinds, **tol)
    assert ps.step == int(new_js.step) == 2
    np.testing.assert_array_equal(ps.queue.valid.numpy(),
                                  np.asarray(new_js.queue.valid))
    np.testing.assert_allclose(float(ps.choice_th), float(new_js.choice_th),
                               rtol=1e-6)


def _log_losses(path):
    """{iteration: loss} of the log's per-epoch loss lines (a run in the
    same process after another writes its lines once per handler)."""
    lines = [ln for ln in open(path).read().splitlines()
             if "iteration" in ln and "sup_loss" in ln]
    return {int(ln.split("iteration ")[1].split()[0]):
            float(ln.split("loss : ")[1].split(",")[0]) for ln in lines}


@pytest.mark.parametrize("model", ["unet2d", "deeplabv2_r50"])
def test_zoo_trainer_runs_on_cpu(model, tmp_path):
    """2 steps with finite losses, the epoch-end evaluation and
    checkpoints, a --load resume for 2 more steps, and the standalone
    evaluator with --save_img on the best model; prostate is one channel,
    so DeepLab's ResNet takes a 1-channel stem (no pretrained file: the
    JAX package's warning, then the random init)."""
    root = generate("prostate", str(tmp_path / "data"), n_train=5,
                    n_test=1, size=32, seed=0)
    common = ["--dataset", "prostate", "--data_root", root, "--model", model,
              "--lb_num", "3", "--num_eval_iter", "2", "--log_interval",
              "1", "--patch_override", "32", "--eval_batch", "2",
              "--domain_num", "2", "--save_name", "z", "--pretrained_root",
              str(tmp_path / "none"), "--model_root", str(tmp_path / "m"),
              "--device", "cpu"]
    tr = train.main(common + ["--max_iterations", "2"])
    assert tr.state.step == 2
    assert type(tr.state.student) is (Unet2D if model == "unet2d"
                                      else DeepLabV2)
    snap = tmp_path / "m" / "prostate" / "z"
    log = open(snap / "log.txt").read()
    assert ("pretrained backbone" in log) == (model != "unet2d")
    for tag in ("test ema model", "test stu model", "save checkpoint to"):
        assert log.count(tag) == 1, tag
    best = f"{model}_avg_dice_best_model.pth"
    assert (snap / "checkpoint.pth").exists() and (snap / best).exists()

    resumed = train.main(common + ["--max_iterations", "4", "--load"])
    assert resumed.start_epoch == 1 and resumed.state.step == 4
    losses = _log_losses(snap / "log.txt")
    assert sorted(losses) == [2, 4], losses
    assert np.isfinite(list(losses.values())).all(), losses

    dice = test_entry.main(["--dataset", "prostate", "--data_root", root,
                            "--model", model, "--save_name", "z",
                            "--model_root", str(tmp_path / "m"),
                            "--domain_num", "2", "--device", "cpu",
                            "--save_img"])
    assert len(dice) == 1 and 0.0 <= dice[0] <= 1.0
    assert sorted(os.listdir(snap / "pred_images")) == [
        "BIDMC_test_000.png", "BMC_test_000.png"]   # one per domain


def test_unet2d_dsbn_cannot_train(tmp_path):
    cfg = config_from_args(build_parser().parse_args(
        ["--model", "unet2d_dsbn", "--device", "cpu"])).resolve()
    with pytest.raises(ValueError, match="domain_label"):
        Trainer(cfg, str(tmp_path))
    # the model itself builds, and runs when given a domain label
    hp = pstep.HyperParams.from_config(cfg)
    net = pstate.build_model(cfg, hp, torch.Generator().manual_seed(0))
    out = net(torch.zeros((2, 32, 32, 1)), domain_label=torch.tensor([1]))
    assert out.shape == (2, 32, 32, 2)
    assert "convd1.bn1.bns.1.running_var" in net.state_dict()


def test_mnms_entry_and_work_alias(tmp_path):
    """train_mnms fixes the MNMS profile (1 channel, 4 classes, parts
    lv/myo/rv) and trains through the same trainer; work is train's
    entry."""
    assert work.main is train.main
    root = generate("MNMS", str(tmp_path / "data"), n_train=5, n_test=1,
                    size=32, seed=0)
    tr = train_mnms.main(["--data_root", root, "--lb_num", "3",
                          "--max_iterations", "2", "--num_eval_iter", "2",
                          "--patch_override", "32", "--eval_batch", "2",
                          "--domain_num", "2", "--save_name", "mn",
                          "--model_root", str(tmp_path / "m"),
                          "--device", "cpu"])
    assert tr.cfg.dataset == "MNMS" and tr.hp.num_classes == 4
    assert tr.state.step == 2
    log = open(tmp_path / "m" / "MNMS" / "mn" / "log.txt").read()
    assert all(f"val_{p}_dice" in log for p in ("lv", "myo", "rv"))
    losses = _log_losses(tmp_path / "m" / "MNMS" / "mn" / "log.txt")
    assert list(losses) == [2] and np.isfinite(losses[2])
    assert (tmp_path / "m" / "MNMS" / "mn" / "train_mnms.py").exists()


@pytest.mark.cuda
def test_deeplab_forward_and_gradients_on_card():
    """On a card: DeepLabV2(resnet50) train forward (3 BN groups) and the
    head's gradients against the same module on the CPU, float32, TF32
    off, within 1e-3 (deeper gradients can jump at a ReLU input within
    rounding of 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ust_run_tpu_torch.engine.trainer import set_numerics
    set_numerics()
    net_cpu = DeepLabV2("resnet50", 2).init_weights_(
        torch.Generator().manual_seed(1))
    net_gpu = DeepLabV2("resnet50", 2).to(
        "cuda", memory_format=torch.channels_last)
    net_gpu.load_state_dict(net_cpu.state_dict())
    g = torch.Generator().manual_seed(2)
    x = torch.rand((6, 64, 64, 3), generator=g) * 2 - 1
    r = torch.randn((6, 64, 64, 2), generator=g)
    outs = []
    for net, dev in ((net_cpu, "cpu"), (net_gpu, "cuda")):
        net.train()
        y = net(x.to(dev), groups=3)
        (y * r.to(dev)).sum().backward()
        outs.append((y.detach().cpu(), {k: p.grad.cpu() for k, p in
                                        net.named_parameters()}))
    assert (outs[0][0] - outs[1][0]).abs().max().item() < 1e-3
    for k in ("classifier.0.weight", "classifier.3.bias"):
        err = ((outs[1][1][k] - outs[0][1][k]).abs().max()
               / outs[0][1][k].abs().max()).item()
        assert err < 1e-3, (k, err)


@pytest.mark.cuda
def test_deeplab_step_on_card(tmp_path):
    """On a card: one step of --model deeplabv2_r50 on a synthetic fundus
    corpus at 64 px, every loss finite, the RNG kernel launched once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = generate("fundus", str(tmp_path / "data"), n_train=5, n_test=1,
                    size=64, seed=0)
    argv = ["--dataset", "fundus", "--data_root", root, "--lb_num", "3",
            "--model", "deeplabv2_r50", "--patch_override", "64",
            "--model_root", str(tmp_path / "m"), "--pretrained_root",
            str(tmp_path / "none"), "--device", "cuda"]
    cfg = config_from_args(build_parser().parse_args(argv)).resolve()
    tr = Trainer(cfg, str(tmp_path / "snap"))
    before = rng.launches
    (m,) = tr.train_steps(1)
    assert rng.launches == before + 1
    assert all(np.isfinite(float(m[k])) for k in LOSSES)
    tr.close()
