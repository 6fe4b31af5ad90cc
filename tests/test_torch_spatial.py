"""The space axis's layout and halo exchange (ust_run_tpu_torch/parallel),
on Gloo ranks on the CPU (tests/torch_dist.py).

  * `halo_rows` is a copy: forward, each rank's slab between its
    neighbours' edge rows (zeros at the image's edges) equals the slice
    of the zero-padded image; backward, each rank's gradient equals the
    slice of the gradient that the padded image's slices accumulate.
    Bit-equal: the values and gradients are integers, exact in float32
    whatever order a sum takes. The slabs are the mesh's own rows at the
    input (H = 48 over 2 ranks as 2 + 1 blocks of 16, H = 64 over 4 ranks,
    and a 2 x 2 mesh whose data indices hold different images) and at the
    UNet's deepest level (the same blocks as 2 + 1 rows).
  * `conv3x3` passes torch.autograd.gradcheck in float64 on 2 ranks, as a
    function of the whole image and weight (replicated in, gathered out),
    and its forward equals F.conv2d with padding 1.
  * `shard` then `gather` gives back the batch bit for bit on a 2 x 2
    mesh with an uneven row split.
  * Validation: a space size that does not divide the ranks raises
    ("divisor", "positive"), as make_mesh does; an image of fewer blocks
    than space ranks (patch 32 on space 4) or of a height that is not a
    multiple of 16 raises; the trainer binds the zoo on a space axis
    (it raised before the zoo ran there).
"""

import pytest
import torch
import torch.nn.functional as F

import torch_dist as td
from ust_run_tpu_torch import parallel
from ust_run_tpu_torch.parallel import spatial
from ust_run_tpu_torch.parallel.mesh import Mesh


def _image(data_index, n=2, c=3, h=48, w=5):
    g = torch.Generator().manual_seed(100 + data_index)
    return torch.randint(-50, 50, (n, c, h, w), generator=g).float()


def _upstream(data_index, space_index, shape):
    g = torch.Generator().manual_seed(200 + 10 * data_index + space_index)
    return torch.randint(-50, 50, shape, generator=g).float()


def _rows(mesh, height, unit):
    """This rank's rows of an image of `height` // 16 blocks of `unit`
    rows each (16: the input; 1: the UNet's deepest level)."""
    sl = mesh.row_slice(height)
    return slice(sl.start // 16 * unit, sl.stop // 16 * unit)


def run_halo(mesh, height, unit):
    x = _image(mesh.data_index, h=height // 16 * unit)
    x = x[:, :, _rows(mesh, height, unit)].clone().requires_grad_()
    y = spatial.halo_rows(x, mesh)
    y.backward(_upstream(mesh.data_index, mesh.space_index, y.shape))
    return dict(y=y.detach(), gx=x.grad)


@pytest.mark.parametrize("world,space,height,unit", [
    (2, 2, 48, 16), (2, 2, 48, 1), (4, 4, 64, 16), (4, 2, 48, 16)])
def test_halo_rows_is_a_copy(tmp_path, world, space, height, unit):
    res = td.run_ranks(tmp_path, world, run_halo, height, unit,
                       spatial=space)
    meshes = [Mesh(rank=r, world=world, device=torch.device("cpu"),
                   space=space) for r in range(world)]
    for d in range(world // space):
        full = _image(d, h=height // 16 * unit)
        padded = F.pad(full, (0, 0, 1, 1))
        grad = torch.zeros_like(padded)
        group = [m for m in meshes if m.data_index == d]
        for m in group:
            rows = _rows(m, height, unit)
            want = padded[:, :, rows.start:rows.stop + 2]
            got = res[m.rank]["y"]
            assert torch.equal(got, want), (m.rank, rows)
            grad[:, :, rows.start:rows.stop + 2] += _upstream(
                d, m.space_index, want.shape)
        for m in group:
            rows = _rows(m, height, unit)
            assert torch.equal(res[m.rank]["gx"],
                               grad[:, :, 1:-1][:, :, rows])
    if (world, height, unit) == (2, 48, 1):
        assert [r["y"].shape[2] - 2 for r in res] == [2, 1]


class _Replicated(torch.autograd.Function):
    """Identity forward; backward sums the ranks' gradient shares, so that
    a replicated input gets the whole gradient on every rank."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        torch.distributed.all_reduce(grad)
        return grad


def run_gradcheck(mesh):
    """conv3x3 as a function of the whole image and weight: each rank
    takes the replicated inputs (`_Replicated`), convolves its rows and
    adds its output rows into the whole output (sum_replicated)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 2, 5, 4), generator=g, dtype=torch.float64)
    wt = torch.randn((3, 2, 3, 3), generator=g, dtype=torch.float64)
    rows = (slice(0, 3), slice(3, 5))[mesh.space_index]

    def whole(x, wt):
        mine = _Replicated.apply(x)[:, :, rows]
        y = spatial.conv3x3(mine, _Replicated.apply(wt), mesh)
        y = F.pad(y, (0, 0, rows.start, x.shape[2] - rows.stop))
        return mesh.sum_replicated(y)

    x.requires_grad_()
    wt.requires_grad_()
    ok = torch.autograd.gradcheck(whole, (x, wt))
    err = (whole(x, wt) - F.conv2d(x, wt, padding=1)).abs().max().item()
    return dict(ok=ok, err=err)


def test_conv3x3_gradcheck_on_two_ranks(tmp_path):
    res = td.run_ranks(tmp_path, 2, run_gradcheck, spatial=2)
    assert [r["ok"] for r in res] == [True, True]
    assert max(r["err"] for r in res) < 1e-12


def run_shard_gather(mesh):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((7, 48, 32, 2), generator=g)
    sizes = (3, 4)
    local, gs = mesh.shard(x, sizes)
    back = mesh.gather(local, sizes, 48)
    bf = mesh.gather(local.to(torch.bfloat16), sizes, 48)
    return dict(equal=torch.equal(back, x),
                bf=torch.equal(bf, x.to(torch.bfloat16)),
                rows=local.shape[1], local=tuple(gs), total=gs.total,
                hw=(gs.height, gs.width))


def test_shard_then_gather_is_exact_on_a_2x2_mesh(tmp_path):
    res = td.run_ranks(tmp_path, 4, run_shard_gather, spatial=2)
    assert all(r["equal"] and r["bf"] for r in res)
    assert [r["rows"] for r in res] == [32, 16, 32, 16]
    assert [r["local"] for r in res] == [(2, 2), (2, 2), (1, 2), (1, 2)]
    assert all(r["total"] == (3, 4) and r["hw"] == (48, 32) for r in res)


def test_row_blocks_and_validation(tmp_path):
    cpu = torch.device("cpu")
    blocks = [Mesh(rank=r, world=4, device=cpu, space=4).row_slice(288)
              for r in range(4)]
    assert [(s.stop - s.start) // 16 for s in blocks] == [5, 5, 4, 4]
    assert blocks[-1].stop == 288
    with pytest.raises(ValueError, match="divisor"):
        parallel.init_distributed(backend="gloo", device="cpu", rank=0,
                                  world_size=4, spatial=3,
                                  init_method=f"file://{tmp_path}/store")
    with pytest.raises(ValueError, match="positive"):
        Mesh(rank=0, world=4, device=cpu, space=0)
    mesh = Mesh(rank=0, world=4, device=cpu, space=4)
    with pytest.raises(ValueError, match="at least one block"):
        mesh.shard(torch.zeros((2, 32, 32, 3)), (2,))      # patch 32
    with pytest.raises(ValueError, match="multiple of 16"):
        mesh.shard(torch.zeros((2, 72, 72, 3)), (2,))
    with pytest.raises(ValueError, match="global height"):
        mesh.gather(torch.zeros((2, 16, 64, 3)), (2,))


@pytest.mark.parametrize("model", ["deeplabv2_r50", "unet2d"])
def test_zoo_on_a_space_axis_raises(tmp_path, model):
    """Named when the zoo raised on a space axis; since the zoo runs there
    (parallel/spatial.py), the trainer builds it on one and binds every
    slab-aware module of both models, and `unet2d_dsbn` still raises
    (tests/test_torch_spatial_bind.py holds the models that do)."""
    from ust_run_tpu_torch.config import build_parser, config_from_args
    from ust_run_tpu_torch.data import synthetic
    from ust_run_tpu_torch.engine.trainer import Trainer
    root = synthetic.generate("fundus", str(tmp_path / "fundus"), n_train=5,
                              n_test=1, size=32, seed=0)
    cfg = config_from_args(build_parser().parse_args([
        "--dataset", "fundus", "--data_root", root, "--lb_num", "3",
        "--patch_override", "32", "--model", model, "--domain_num", "1",
        "--device", "cpu", "--pretrained_root", str(tmp_path / "none")]))
    mesh = Mesh(rank=0, world=2, device=torch.device("cpu"), space=2)
    trainer = Trainer(cfg.resolve(), str(tmp_path / "snap"), mesh)
    for net in (trainer.state.student, trainer.state.teacher):
        aware = [m for m in net.modules()
                 if isinstance(m, spatial.SlabAware)]
        assert aware and all(m.mesh is mesh for m in aware)
    cfg.model = "unet2d_dsbn"
    with pytest.raises(ValueError, match="domain_label"):
        Trainer(cfg.resolve(), str(tmp_path / "snap2"), mesh)
