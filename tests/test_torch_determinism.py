"""The zoo's step without atomics, `--deterministic`, and the K-step call
on a mesh (ust_run_tpu_torch: parallel/spatial.py, models/deeplab.py,
models/unet2d.py, engine/trainer.py:set_numerics, the entries,
semisup/step.py:multi_step), on the CPU.

  * Every resize of the zoo is two interpolation-matrix products, as the
    JAX package computes DeepLab's: DeepLab's align-corners resize
    against ust_run_tpu/models/deeplab.py:resize_align_corners, Unet2D's
    x2 upsampling and its deep-supervision heads against
    jax.image.resize(..., "bilinear"), each against F.interpolate (which
    it replaces), values and gradients. Bars: float32, values in [-1, 1):
    a value is a two-term sum in another order, rtol 1e-6 with a floor of
    1e-6; a gradient sums up to (H2/H x W2/W) x 4 terms (64 x 4 at x8)
    in another order, rtol 1e-5 with a floor of 1e-5; F.interpolate's
    align-corners weights come from float32 positions (off by up to an
    ulp of H, 2^-18 at 32 rows, times a difference of two values up to
    2), 1e-5 as well.
  * The halo's backward folds with three 0/1 matrices: on every plan of
    tests/test_torch_spatial_halo.py, each part equals the index_add_
    fold it replaces, bit for bit (integer values, exact in any order).
  * `--deterministic` is read by every entry (train, train_mnms, test,
    bench): at 1 cuDNN is deterministic and does not
    benchmark, and `random`/`np.random` are seeded from `--seed` as the
    JAX CLI seeds them (ust_run_tpu/cli.py:69-71, called here); at 0
    cuDNN benchmarks and nothing is seeded.
  * `multi_step` on a Gloo mesh runs K eager steps equal to K single
    steps (Gloo cannot be captured; NCCL can), and the graph key tells
    mesh layouts apart.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import test_torch_spatial_halo as halo_cases
from torch_unroll import (assert_states_equal, corpus, hp_for, index_rows,
                          new_state)
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.models import deeplab as jax_deeplab
from ust_run_tpu_torch import bench, cli, test as test_entry
from ust_run_tpu_torch import train, train_mnms
from ust_run_tpu_torch.engine.trainer import set_numerics
from ust_run_tpu_torch.models import deeplab
from ust_run_tpu_torch.parallel import spatial
from ust_run_tpu_torch.parallel.mesh import Mesh
from ust_run_tpu_torch.semisup import step as pstep

pytestmark = pytest.mark.usefixtures("single_thread")

RTOL = ATOL = 1e-6
GRAD_TOL = 1e-5


def _x(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


def _value_and_grad(fn, x, gy):
    """fn(x) and the gradient of <fn(x), gy> with respect to x."""
    t = torch.from_numpy(x).requires_grad_()
    y = fn(t)
    y.backward(torch.from_numpy(gy))
    return y.detach().numpy(), t.grad.numpy()


# (N, C, H, W) -> (H2, W2): DeepLab's x8 logits resize, odd sizes, and the
# test-time augmentation's shrinking and enlarging scales
ALIGN = [((2, 3, 4, 4), (32, 32)), ((1, 2, 5, 7), (17, 9)),
         ((2, 3, 32, 32), (16, 24)), ((1, 3, 32, 32), (48, 64))]


@pytest.mark.parametrize("shape,size", ALIGN)
def test_align_corners_resize_is_jaxs(shape, size):
    x = _x(shape, 0)
    gy = _x(shape[:2] + size, 1)
    got, grad = _value_and_grad(
        lambda t: deeplab.resize_align_corners(t, *size), x, gy)
    want = np.asarray(jax_deeplab.resize_align_corners(
        jnp.asarray(x.transpose(0, 2, 3, 1)), *size)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ref, ref_grad = _value_and_grad(
        lambda t: F.interpolate(t, size=size, mode="bilinear",
                                align_corners=True), x, gy)
    np.testing.assert_allclose(got, ref, rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(grad, ref_grad, rtol=GRAD_TOL, atol=GRAD_TOL)


# (N, C, H, W) -> (H2, W2): Unet2D's x2 upsampling, and its heads' x4 to
# x16 (the bottleneck's 2 x 2 to 32 x 32 at patch 32)
BILINEAR = [((2, 4, 4, 4), (8, 8)), ((1, 3, 5, 7), (10, 14)),
            ((2, 2, 8, 8), (32, 32)), ((1, 2, 2, 2), (32, 32))]


@pytest.mark.parametrize("shape,size", BILINEAR)
def test_bilinear_resize_is_jax_image_resize(shape, size):
    x = _x(shape, 2)
    gy = _x(shape[:2] + size, 3)
    got, grad = _value_and_grad(
        lambda t: spatial.resize_bilinear(t, *size), x, gy)
    n, c = shape[:2]
    want = np.asarray(jax.image.resize(
        jnp.asarray(x.transpose(0, 2, 3, 1)), (n,) + size + (c,),
        "bilinear")).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ref, ref_grad = _value_and_grad(
        lambda t: F.interpolate(t, size=size, mode="bilinear",
                                align_corners=False), x, gy)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, ref_grad, rtol=GRAD_TOL, atol=GRAD_TOL)
    if size == tuple(2 * s for s in shape[2:]):
        up, _ = _value_and_grad(spatial.upsample2x, x, gy)
        np.testing.assert_array_equal(up, got)


def _index_add_fold(plan, g_halo, h, buf_in):
    """The halo backward's fold before the matrices (index_add_ over the
    plan's indices): (this rank's gradient from its local halo rows, the
    buffer of its other halo rows, the rows it sent from `buf_in`)."""
    n, c, _, w = g_halo.shape
    nl = len(plan.local)

    def idx(rows):
        return torch.tensor(rows, dtype=torch.int64)

    g_pool = g_halo.new_zeros((n, c, nl + plan.slots + 1, w)).index_add_(
        2, idx(plan.idx), g_halo)
    gx = g_halo.new_zeros((n, c, h, w))
    if nl:
        gx.index_add_(2, idx(plan.local), g_pool[:, :, :nl])
    recv = g_halo.new_zeros((n, c, h, w))
    if plan.send:
        recv.index_add_(2, idx(plan.send),
                        buf_in.index_select(2, idx(plan.send_slots)))
    return gx, g_pool[:, :, nl:nl + plan.slots], recv


def _plans(space):
    """(plan, slab height) of every rank in every case of the halo tests."""
    for bounds, top, bottom, fill, given in halo_cases.cases(space):
        for me, (a, b) in enumerate(bounds):
            yield (spatial._layout_plan(bounds, me, top, bottom, fill)
                   if given else spatial._neighbour_plan(
                       me, space, b - a, top, bottom, fill)), b - a


@pytest.mark.parametrize("space", [2, 4])
def test_halo_fold_is_the_index_add_fold(space):
    g = torch.Generator().manual_seed(space)
    n = 0
    for plan, h in _plans(space):
        rows = plan.top + plan.bottom
        g_halo = torch.randint(-50, 50, (2, 3, rows, 5), generator=g).float()
        buf = torch.randint(-50, 50, (2, 3, plan.slots, 5),
                            generator=g).float()
        local, slots, recv = (torch.from_numpy(m)
                              for m in spatial._fold(plan, h))
        want = _index_add_fold(plan, g_halo, h, buf)
        got = (spatial.rows_product(local, g_halo),
               spatial.rows_product(slots, g_halo),
               spatial.rows_product(recv, buf))
        for a, b in zip(got, want):
            assert torch.equal(a, b), plan
        n += 1
    assert n > 100


@pytest.fixture
def numerics():
    """The global RNGs and cuDNN's flags, restored after the test."""
    state = (random.getstate(), np.random.get_state(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    yield
    random.setstate(state[0])
    np.random.set_state(state[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        state[2:]


class _Stop(Exception):
    pass


# entry -> (its module whose set_numerics it calls, argv after the flag,
# the seed it seeds with)
ENTRIES = {
    "train": (cli, lambda root: train.main, ["--dataset", "fundus",
                                             "--seed", "5"], 5),
    "train_mnms": (cli, lambda root: train_mnms.main, ["--seed", "6"], 6),
    "test": (test_entry, lambda root: test_entry.main, [], 1337),
    "bench": (bench, lambda root: bench.main, [], 1337),
}


@pytest.mark.parametrize("det", [1, 0])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_every_entry_reads_deterministic(entry, det, numerics, tmp_path,
                                         monkeypatch):
    module, main, extra, seed = ENTRIES[entry]
    seen = []

    def spy(deterministic=1, seed=None):
        seen.append((deterministic, seed))
        set_numerics(deterministic, seed)
        raise _Stop

    monkeypatch.setattr(module, "set_numerics", spy)
    random.seed(99)
    np.random.seed(99)
    torch.backends.cudnn.deterministic = not det
    torch.backends.cudnn.benchmark = bool(det)
    argv = ["--device", "cpu", "--deterministic", str(det)] + extra
    if entry in ("train", "train_mnms", "test"):
        argv += ["--model_root", str(tmp_path), "--save_name", "d"]
    with pytest.raises(_Stop):
        main(tmp_path)(argv)
    assert [d for d, _ in seen] == [det]
    assert torch.backends.cudnn.deterministic == bool(det)
    assert torch.backends.cudnn.benchmark == (not det)
    want = seed if det else 99
    assert random.random() == random.Random(want).random()
    assert np.random.rand() == np.random.RandomState(want).rand()


def test_port_seeds_as_the_jax_cli(numerics, tmp_path, monkeypatch):
    """The train entry's bootstrap leaves `random` and `np.random` where
    the JAX CLI's leaves them, from the same flags."""
    import logging
    from ust_run_tpu import cli as jax_cli
    from ust_run_tpu.config import build_parser as jax_parser
    from ust_run_tpu_torch.config import build_parser
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    flags = ["--dataset", "fundus", "--seed", "7", "--save_name", "s",
             "--overwrite"]
    try:
        jax_cli.bootstrap(jax_parser().parse_args(
            flags + ["--model_root", str(tmp_path / "jax")]), __file__)
        want = (random.random(), np.random.rand())
        cli.bootstrap(build_parser().parse_args(
            flags + ["--model_root", str(tmp_path / "port"), "--device",
                     "cpu"]), __file__)
        assert (random.random(), np.random.rand()) == want
    finally:
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        root.setLevel(level)


@pytest.fixture
def gloo_world1(tmp_path):
    """A one-rank Gloo process group on the CPU, as a Mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield Mesh(rank=0, world=1, device=torch.device("cpu"),
                   group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def test_gloo_mesh_multi_step_is_k_eager_steps(gloo_world1):
    mesh, k = gloo_world1, 2
    assert not pstep.capturable(mesh) and pstep.capturable(None)
    hp = hp_for("fundus")
    data = corpus(hp, 4)
    single, multi = new_state(hp, 8), new_state(hp, 8)
    rows = index_rows(9, k, hp)
    want = torch.stack([pstep.step_fn(single, data, idx, hp, mesh)
                        for idx in rows])
    feeds = torch.from_numpy(pstep.draw_feeds(multi, hp, k))
    idxs = {name: torch.stack([r[name] for r in rows]) for name in rows[0]}
    pstep.reset_counts()
    got = pstep.multi_step(multi, data, idxs, feeds, hp, mesh)
    assert torch.equal(got, want)
    assert_states_equal(single, multi)
    assert multi.graph is None and pstep.graph_counts["captures"] == 0


def test_capturable_reads_the_backend(monkeypatch):
    mesh = Mesh(rank=0, world=1, device=torch.device("cpu"), group="g")
    for backend, want in (("nccl", True), ("gloo", False)):
        monkeypatch.setattr(pstep.dist, "get_backend", lambda g: backend)
        assert pstep.capturable(mesh) is want


def test_graph_key_tells_mesh_layouts_apart():
    hp = hp_for("fundus")
    data = corpus(hp, 0)

    def mesh(rank, world, space):
        return Mesh(rank=rank, world=world, device=torch.device("cpu"),
                    space=space)

    keys = [pstep._graph_key(data, hp, m) for m in (
        None, mesh(0, 1, 1), mesh(0, 2, 1), mesh(1, 2, 1), mesh(0, 2, 2),
        mesh(0, 4, 2), mesh(2, 4, 2))]
    assert len(set(keys)) == len(keys)
    assert pstep._graph_key(data, hp, mesh(1, 4, 2)) \
        == pstep._graph_key(data, hp, mesh(1, 4, 2))
