"""Package-level checks of ust_run_tpu_torch: it imports no JAX, it has no
silent CPU fallback, its CLI mirrors the JAX package's, its trainer runs
end to end on the CPU when asked to (training, evaluation, checkpoints,
--eval, --load and the standalone evaluator), and (on a card only) its
CUDA kernels agree with their plain versions. The file imports no JAX at
the top, so the card tests run where JAX is not installed:
`python -m pytest --noconftest -m cuda tests/test_torch_package.py`."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_threads import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports with jax, flax,
    optax and ust_run_tpu blocked."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "ust_run_tpu"):
    sys.modules[name] = None          # any import of these now fails
import ust_run_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ust_run_tpu_torch.__path__,
                                               "ust_run_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "optax", "ust_run_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
print(" ".join(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 42
    assert {f"ust_run_tpu_torch.{m}" for m in (
        "ops.fused_conv", "utils.boundary", "utils.boundary_native",
        "engine.evaluator", "engine.checkpoint", "test", "nan_replay",
        "parity_runs", "data.dl_utils", "data.transform", "data.ssda",
        "data.extra_transforms", "parallel.spatial", "bench",
        "perf_breakdown")} <= mods


def test_no_cpu_fallback(tmp_path, monkeypatch):
    """Without CUDA, every entry raises unless the CPU is asked for."""
    from ust_run_tpu_torch import bench, nan_replay, perf_breakdown
    from ust_run_tpu_torch import test as test_entry
    from ust_run_tpu_torch import train
    from ust_run_tpu_torch.ops import fused_conv, rng
    from ust_run_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        rng.uniform_batch(2, 8, generator=g, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--dataset", "fundus", "--model_root", str(tmp_path),
                    "--data_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        test_entry.main(["--dataset", "fundus", "--model_root",
                         str(tmp_path), "--data_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        nan_replay.main(["--dump", str(tmp_path), "--", "--dataset",
                         "fundus", "--data_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        perf_breakdown.main([])
    # (bench.main also starts its watchdog; its subprocess test is in
    # tests/test_torch_bench.py)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.Bench(bench.bench_config({})[0])
    assert not os.listdir(tmp_path)          # raised before touching files
    assert rng.uniform_batch(2, 8, generator=g, device="cpu").shape \
        == (2, 8, 8)
    # the fused conv takes its plain version only for a CPU tensor, and
    # raises for any other device instead of carrying on there
    y = torch.ones((1, 8, 8, 4))
    args = (torch.ones((1, 4)), torch.zeros((1, 4)), torch.ones((3, 3, 4, 4)))
    before = fused_conv.launches
    assert fused_conv.bn_relu_conv3x3(y, *args)[0].shape == (1, 8, 8, 4)
    assert fused_conv.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fused_conv.bn_relu_conv3x3(y.to("meta"),
                                   *(a.to("meta") for a in args))


def test_cli_and_hyperparams_mirror_jax():
    from ust_run_tpu.config import build_parser as jax_parser
    from ust_run_tpu.semisup.step import HyperParams as JaxHP
    from ust_run_tpu_torch.config import build_parser
    from ust_run_tpu_torch.semisup.step import HyperParams

    ours = {a.dest: a.default for a in build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    assert [f.name for f in dataclasses.fields(HyperParams)] == \
        [f.name for f in dataclasses.fields(JaxHP)]


def test_trainer_entry_runs_on_cpu_when_asked(tmp_path):
    """The module entries end to end at a tiny size with --device cpu: a
    synthetic fundus corpus, two epochs of two steps with finite losses,
    an EMA and student evaluation and a checkpoint at each epoch end, the
    RNG's plain version on the CPU; then --load resumes for a third
    epoch, --eval evaluates and saves nothing, and the standalone
    evaluator reads the best model and writes its overlays."""
    from ust_run_tpu_torch import test as test_entry
    from ust_run_tpu_torch import train
    from ust_run_tpu_torch.data.synthetic import generate
    from ust_run_tpu_torch.ops import rng

    root = generate("fundus", str(tmp_path / "fundus"), n_train=5,
                    n_test=1, size=32, seed=0)
    common = ["--dataset", "fundus", "--data_root", root, "--lb_domain", "1",
              "--lb_num", "3", "--num_eval_iter", "2", "--log_interval",
              "1", "--patch_override", "32", "--eval_batch", "2",
              "--model_root", str(tmp_path / "model"), "--device", "cpu"]
    before = rng.launches
    trainer = train.main(common + ["--save_name", "t", "--max_iterations",
                                   "4"])
    assert trainer.iter_num == 4 and trainer.state.step == 4
    assert rng.launches == before             # no kernel on the CPU
    snap = tmp_path / "model" / "fundus" / "t"
    log = open(snap / "log.txt").read()
    lines = [ln for ln in log.splitlines() if "iteration" in ln
             and "sup_loss" in ln]
    assert len(lines) == 2, log
    for ln in lines:
        loss = float(ln.split("loss : ")[1].split(",")[0])
        assert np.isfinite(loss)
    assert "epoch 2:" in log
    for tag in ("test ema model", "test stu model", "save checkpoint to"):
        assert log.count(tag) == 2, tag
    assert "save cur best avg model to" in log
    assert (snap / "checkpoint.pth").exists()
    assert (snap / "unet_avg_dice_best_model.pth").exists()

    resumed = train.main(common + ["--save_name", "t", "--max_iterations",
                                   "6", "--load"])
    assert resumed.start_epoch == 2 and resumed.state.step == 6
    assert "Models restored from epoch 2" in open(snap / "log.txt").read()

    ev = train.main(common + ["--save_name", "e", "--eval"])
    assert ev.state.step == 0
    assert sorted(os.listdir(tmp_path / "model" / "fundus" / "e")) == [
        "log", "log.txt", "train.py"]

    # the standalone evaluator decodes at the profile's 256 px (it has no
    # --patch_override), so one domain keeps it small
    dice = test_entry.main(["--dataset", "fundus", "--data_root", root,
                            "--save_name", "t", "--model_root",
                            str(tmp_path / "model"), "--domain_num", "1",
                            "--device", "cpu"])
    assert len(dice) == 2 and all(0.0 <= d <= 1.0 for d in dice)
    assert "val_cup_hd" in open(snap / "test_log.txt").read()
    # --save_img: one side-by-side overlay per test image
    test_entry.main(["--dataset", "fundus", "--data_root", root,
                     "--save_name", "t", "--model_root",
                     str(tmp_path / "model"), "--domain_num", "1",
                     "--device", "cpu", "--save_img"])
    assert sorted(os.listdir(snap / "pred_images")) == ["d1_test_000.png"]


@pytest.mark.cuda
def test_uniform_kernel_bit_equal_on_card():
    """On a card: the CUDA kernel equals its plain version bit for bit at
    the main path's shape and a ragged one, and counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from ust_run_tpu_torch.ops import rng

    for n, size in ((16, 256), (3, 37)):
        out = torch.empty((n, size, size), device="cuda")
        before = rng.launches
        rng.uniform_fields(out, 12345)
        assert rng.launches == before + 1
        plain = rng.uniform_batch_plain(n, size, 12345, device="cuda")
        assert torch.equal(out, plain)


def _fused_inputs_on_card(b, h, w, c, co, dtype, rng):
    y, inv, shift, wk = (torch.from_numpy(a.astype(np.float32)).cuda()
                         for a in (rng.normal(size=(b, h, w, c)),
                                   rng.uniform(0.5, 1.5, (b, c)),
                                   rng.normal(size=(b, c)) * 0.3,
                                   rng.normal(size=(3, 3, c, co)) * 0.1))
    return y.to(dtype), inv, shift, wk


def _fused_launch_on_card(fc, args, want):
    """One launch through the wrapper: the library's plan is `want` (route,
    N tile, K chunk), the launch counts once in all and once on its
    route; returns the kernel's (out, m1, m2) and the plain version's."""
    y, _, _, wk = args
    b, h, w, c = y.shape
    geom = fc.library_plan(y.dtype, c, wk.shape[-1], h, w)
    assert (geom.route, geom.tile_n, geom.tile_k) == want
    before, on_route = fc.launches, fc.route_launches[geom.route]
    got = fc.bn_relu_conv3x3(*args)
    torch.cuda.synchronize()
    assert fc.launches == before + 1
    assert fc.route_launches[geom.route] == on_route + 1
    return got, fc.bn_relu_conv3x3_plain(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_conv_kernel_matches_plain_on_card(dtype):
    """On a card: the bn_relu_conv3x3 kernel against its plain version
    (TF32 off) at the JAX test shapes and a ragged one (C = 3, Co = 70);
    f32 to 1e-4 (accumulation order over K up to 576), bf16 `out` within
    one bf16 ulp, moments to rtol 1e-5 plus 1e-5 of their largest
    magnitude (the f32 summation order of the tile reduce; these shapes
    have 1-8 tiles per sample, so a tile dropped from the reduce moves a
    moment by a tenth or more). In bf16, the first three shapes take the
    TMA + wgmma route and (2, 19, 37, 3, 70) the WMMA route; f32 takes
    the WMMA route everywhere. The library's plan is checked against
    `plan` and each launch counts on its route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from ust_run_tpu_torch.ops import fused_conv as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    bf16 = dtype == torch.bfloat16
    for shape, want in [((2, 16, 16, 8, 8), (1, 64, 64)),
                        ((1, 32, 24, 16, 8), (1, 64, 64)),
                        ((1, 16, 16, 64, 16), (1, 64, 64)),
                        ((2, 19, 37, 3, 70), (0, 64, 32))]:
        if not bf16:
            want = (0, 64, 16)
        args = _fused_inputs_on_card(*shape, dtype, rng)
        (out, m1, m2), (p_out, p1, p2) = _fused_launch_on_card(fc, args,
                                                               want)
        if dtype == torch.float32:
            torch.testing.assert_close(out, p_out, rtol=1e-4, atol=1e-4)
        else:
            ulp = torch.finfo(torch.bfloat16).eps * p_out.float().abs()
            assert bool(((out.float() - p_out.float()).abs()
                         <= ulp + 1e-30).all())
        for m, p in ((m1, p1), (m2, p2)):
            torch.testing.assert_close(m, p, rtol=1e-5,
                                       atol=1e-5 * p.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,want", [
    ((2, 40, 50, 136, 200), (1, 128, 64)),
    ((2, 19, 37, 64, 72), (1, 128, 64))])
def test_fused_conv_tma_masks_on_card(shape, want):
    """On a card, bf16: the TMA route where its masks matter. Both shapes
    have ragged image edges and N tile 128 with a partial last N tile
    (200 = 128 + 72, 72 = 64 + 8); the first also has three K chunks, the
    last of 8 channels (TMA's zero fill past C). `out` within one bf16 ulp
    plus 1e-5 of max |plain| (K = 9 x 136 = 1224 terms: near-cancelling
    sums let the f32 order move the rounding), moments to rtol 1e-5 plus
    1e-5 of their largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from ust_run_tpu_torch.ops import fused_conv as fc

    args = _fused_inputs_on_card(*shape, torch.bfloat16,
                                 np.random.RandomState(1))
    (out, m1, m2), (p_out, p1, p2) = _fused_launch_on_card(fc, args, want)
    p = p_out.float()
    bar = torch.finfo(torch.bfloat16).eps * p.abs() + 1e-5 * p.abs().max()
    assert bool(((out.float() - p).abs() <= bar).all())
    for m, pm in ((m1, p1), (m2, p2)):
        torch.testing.assert_close(m, pm, rtol=1e-5,
                                   atol=1e-5 * pm.abs().max().item())


@pytest.mark.cuda
def test_world1_nccl_trainer_equals_plain_trainer_on_card(tmp_path):
    """On a card: the trainer on a one-rank NCCL process group
    (ust_run_tpu_torch.parallel: shards, gathers, loss partial sums,
    synchronised BatchNorm and the gradient all-reduce, each an identity
    at world 1) takes the plain trainer's steps bit for bit: 3 fundus
    steps at patch 64, bf16 autocast, at the default --unroll_steps 10 (a
    call of 3: one eager step, then the step with its NCCL collectives
    captured once and replayed twice), every state tensor and metric
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL has no CPU mode)")
    from torch_dist import state_tensors
    from ust_run_tpu_torch import parallel
    from ust_run_tpu_torch.config import build_parser, config_from_args
    from ust_run_tpu_torch.data.synthetic import generate
    from ust_run_tpu_torch.engine.trainer import Trainer
    from ust_run_tpu_torch.semisup import step

    root = generate("fundus", str(tmp_path / "fundus"), n_train=5,
                    n_test=1, size=64, seed=0)

    def run(name, mesh=None):
        cfg = config_from_args(build_parser().parse_args([
            "--dataset", "fundus", "--data_root", root, "--lb_domain", "1",
            "--lb_num", "3", "--patch_override", "64", "--save_name", name,
            "--model_root", str(tmp_path / "model"), "--device",
            "cuda"])).resolve()
        os.makedirs(tmp_path / name)
        trainer = Trainer(cfg, str(tmp_path / name), mesh)
        metrics = trainer.train_steps(3)
        state = state_tensors(trainer.state)
        trainer.close()
        return metrics, state

    plain_metrics, plain = run("plain")
    mesh = parallel.init_distributed(
        backend="nccl", device="cuda:0", rank=0, world_size=1,
        init_method=f"file://{tmp_path / 'store'}")
    try:
        step.reset_counts()
        metrics, state = run("nccl", mesh)
    finally:
        mesh.close()
    assert step.graph_counts == dict(captures=1, replays=2)
    assert state.keys() == plain.keys()
    assert [k for k in state if not torch.equal(state[k], plain[k])] == []
    for m, want in zip(metrics, plain_metrics):
        for k in want:
            np.testing.assert_array_equal(m[k], want[k], err_msg=k)


@pytest.mark.cuda
def test_fused_sgd_matches_cpu_on_card():
    """On a card: one update of the step's optimizer (make_optimizer:
    momentum 0.9, weight decay 1e-4, a 0-d lr on the parameters' device),
    SGD(fused=True) as the step runs it on CUDA, against the CPU's
    unfused update from equal parameters, gradients and momentum, on
    tensors of the UNet's sizes: within 4 float32 ulp of the larger
    operand of each last operation (chip_smoke.py's SGD_ULP; the H100
    reads 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ust_run_tpu_torch.semisup.state import lr_at, make_optimizer
    r = np.random.RandomState(0)
    shapes = [(64, 3, 3, 3), (64,), (1024, 512, 3, 3), (2, 64, 1, 1)]
    p0, g0, b0 = ([torch.from_numpy(r.normal(0, s, sh).astype(np.float32))
                   for sh in shapes] for s in (0.1, 1e-2, 1e-2))
    lr = lr_at(1000, 0.03, 30000)

    def update(device, fused):
        ps = [p.to(device, copy=True).requires_grad_() for p in p0]
        opt = make_optimizer(ps, 0.03, fused=fused)
        for p, g, b in zip(ps, g0, b0):       # copies: SGD updates in place
            p.grad = g.to(device, copy=True)
            opt.state[p]["momentum_buffer"] = b.to(device, copy=True)
        for group in opt.param_groups:
            group["lr"] = torch.tensor(lr, device=device)
        opt.step()
        return ([p.detach().cpu() for p in ps],
                [opt.state[p]["momentum_buffer"].cpu() for p in ps])

    (want_p, want_b), (got_p, got_b) = update("cpu", False), \
        update("cuda", True)

    def ulps(got, want, scale):
        return float(((got.double() - want.double()).abs()
                      / np.spacing(scale.numpy())).max())

    for p, g, b, wp, wb, gp, gb in zip(p0, g0, b0, want_p, want_b, got_p,
                                       got_b):
        assert ulps(gb, wb, torch.maximum((0.9 * b).abs(),
                                          (g + 1e-4 * p).abs())) <= 4
        assert ulps(gp, wp, torch.maximum(p.abs(), (lr * wb).abs())) <= 4
