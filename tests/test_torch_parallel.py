"""Data parallelism of the port (ust_run_tpu_torch/parallel) on the CPU:
ranks spawned over a Gloo group (tests/torch_dist.py) against the
single-process port on the same inputs. The train step on ranks is in
test_torch_parallel_step.py (against one process) and
test_torch_parallel_jax.py (against the JAX step).

The contract, as for the JAX mesh (tests/test_parallel.py:47-80): N ranks
with global batch label_bs + unlabel_bs compute what one process computes,
within float summation order. Bars:
  * the gradient convention and GroupedBatchNorm alone: 1e-6 (float32
    sums of a few terms in another order);
  * the sharded evaluation: 1e-6. A sample's masks and boundary metrics
    are its own whatever batch it shares, but its dice and loss are
    float32 reductions whose order may follow the batch (measured: 2e-8
    relative, a float32 ulp).
The `torchrun` launch of the entries is in test_torch_parallel_cli.py.
"""

import numpy as np
import pytest
import torch

import torch_dist as td
from ust_run_tpu_torch import train
from ust_run_tpu_torch.data import synthetic
from ust_run_tpu_torch.parallel import check_num_devices, shard_slice
from ust_run_tpu_torch.parallel.mesh import DataMesh


def _rows(sizes, world):
    """Global row of each local row, rank after rank."""
    order = []
    for rank in range(world):
        start = 0
        for n in sizes:
            sl = shard_slice(n, rank, world)
            order += range(start + sl.start, start + sl.stop)
            start += n
    return torch.argsort(torch.tensor(order))


def test_shard_slice_and_layout():
    """Contiguous shares, the first n % world ranks one row longer, empty
    shares allowed; `shard` takes each group's share."""
    assert [shard_slice(5, r, 2) for r in range(2)] == [slice(0, 3),
                                                        slice(3, 5)]
    assert [shard_slice(1, r, 4) for r in range(4)] == [
        slice(0, 1), slice(1, 1), slice(1, 1), slice(1, 1)]
    for n in range(7):
        for world in (1, 2, 3, 4):
            got = sum((list(range(n))[shard_slice(n, r, world)]
                       for r in range(world)), [])
            assert got == list(range(n))
    x = torch.arange(7)
    mesh = DataMesh(rank=1, world=2, device=torch.device("cpu"))
    rows, local = mesh.shard(x, (2, 4, 1))
    assert rows.tolist() == [1, 4, 5] and local == (1, 2, 0)


def test_num_devices_must_match_world(tmp_path):
    """--num_devices names the mesh size: any value but the number of
    ranks raises (make_mesh's validation), before any data is read."""
    check_num_devices(None, 3)
    check_num_devices(2, 2)
    with pytest.raises(ValueError, match="must be positive"):
        check_num_devices(0, 1)
    with pytest.raises(ValueError, match="2-device mesh but the run has 1"):
        check_num_devices(2, 1)
    with pytest.raises(ValueError, match="4-device mesh but the run has 1"):
        train.main(["--dataset", "fundus", "--num_devices", "4", "--device",
                    "cpu", "--model_root", str(tmp_path), "--data_root",
                    str(tmp_path / "no_data")])


def test_gradient_convention(tmp_path):
    """On 2 ranks the summed gradient is the global loss's: through a
    replicated consumer (loss partial sums, backward passes through) and a
    sharded one (BN statistics, backward sums). An all-reduce in the
    replicated consumer's backward gives exactly N times it; the same
    holds for ce_plus_dice, whose global loss and gradient differ from the
    mean of the ranks' local losses."""
    world = 2
    x = td.convention_inputs().requires_grad_()
    l1, l2 = td.convention_losses(x)
    g1, = torch.autograd.grad(l1, x)
    g2, = torch.autograd.grad(l2, x)
    for n_fold in (False, True):
        res = td.run_ranks(tmp_path, world, td.run_convention, n_fold)
        for r in res:
            torch.testing.assert_close(r["l1"], l1.detach(), rtol=1e-6,
                                       atol=0)
        got1 = torch.cat([r["g1"] for r in res])
        got2 = torch.cat([r["g2"] for r in res])
        torch.testing.assert_close(got2, g2, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got1, world * g1 if n_fold else g1,
                                   rtol=1e-6, atol=1e-6)

    logits, target, mask = td.dice_inputs()
    logits.requires_grad_()
    from ust_run_tpu_torch.utils import losses as L
    loss = L.ce_plus_dice(logits, target, multilabel=True, n_classes=2,
                          mask=mask)
    grad, = torch.autograd.grad(loss, logits)
    res = td.run_ranks(tmp_path, world, td.run_ce_dice)
    for r in res:
        torch.testing.assert_close(r["global"][0], loss.detach(), rtol=1e-6,
                                   atol=0)
    torch.testing.assert_close(torch.cat([r["global"][1] for r in res]),
                               grad, rtol=1e-5, atol=1e-8)
    # the mean of the local losses: 0.11 higher, its gradient 18% off
    mean_local = torch.cat([r["local"][1] for r in res]) / world
    assert (mean_local - grad).norm() > 0.1 * grad.norm()
    assert abs(np.mean([float(r["local"][0]) for r in res])
               - float(loss.detach())) > 0.05


@pytest.mark.parametrize("world,sizes,valid", [
    (2, (3, 1, 2), [True, True, False]),   # rank 1: nothing of group 2
    (4, (2, 1), [True, True])])            # ranks 2 and 3: no sample
def test_grouped_bn_cross_replica(tmp_path, world, sizes, valid):
    """GroupedBatchNorm on the ranks' slices: outputs, input gradients,
    the summed affine gradients and the running statistics of one
    process, with empty slices and an invalid group."""
    ref = td.run_bn(None, sizes, valid)
    res = td.run_ranks(tmp_path, world, td.run_bn, sizes, valid)
    inv = _rows(sizes, world)
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([r["y"] for r in res])[inv],
                               ref["y"], **tol)
    torch.testing.assert_close(torch.cat([r["gx"] for r in res])[inv],
                               ref["gx"], **tol)
    for k in ("gw", "gb"):
        torch.testing.assert_close(sum(r[k] for r in res), ref[k], rtol=1e-5,
                                   atol=1e-5)
    for r in res:
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(r[k], ref[k], **tol)
        assert int(r["tracked"]) == int(ref["tracked"]) == sum(valid)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """A synthetic fundus corpus at patch 32 with 3 test images in each of
    2 domains, and UNet weights that give non-trivial masks."""
    root = str(tmp_path_factory.mktemp("eval") / "fundus")
    synthetic.generate("fundus", root, n_train=2, n_test=3, size=32, seed=0)
    return root, td.centred_unet("fundus", root, 32, (1, 2), seed=2)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_evaluation_matches_one_process(tmp_path, eval_setup, world):
    """Each rank evaluates a contiguous share of each domain in padded
    batches of 2 (world 2: 2 + 1 samples; world 4: ranks 0-2 one each,
    rank 3 none) and every rank returns one process's per-domain and
    overall metrics and loss."""
    root, sd = eval_setup
    args = ("fundus", root, 32, (1, 2), 2, sd)
    with td.one_thread():
        ref = td.run_eval(None, *args)
    res = td.run_ranks(tmp_path, world, td.run_eval, *args)
    want_local = {2: [4, 2], 4: [2, 2, 2, 0]}[world]
    assert [r["n_local"] for r in res] == want_local
    assert 0.0 < ref["metrics"][0].min() < ref["metrics"][0].max() < 1.0
    for r in res:
        np.testing.assert_allclose(r["metrics"], ref["metrics"], rtol=1e-6,
                                   atol=1e-6)
        assert abs(r["loss"] - ref["loss"]) <= 1e-6
        for d, want in zip(r["domains"], ref["domains"]):
            np.testing.assert_allclose(d["metrics"], want["metrics"],
                                       rtol=1e-6, atol=1e-6)
