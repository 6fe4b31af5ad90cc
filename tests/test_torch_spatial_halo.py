"""The space axis's general halo (ust_run_tpu_torch/parallel/spatial.py
`halo_rows` with widths, fills and a row layout), on Gloo ranks on the
CPU (tests/torch_dist.py).

  * `halo_rows` is a copy: forward, each rank's slab between its `top`
    rows above and `bottom` rows below equals the slice of the whole
    image padded with the fill (zeros, -inf, or the edge row repeated);
    backward, each rank's gradient equals the slice of the gradient that
    the padded image's slices accumulate, returned to the owner however
    far away it is. Bit-equal: the values and gradients are integers,
    exact in float32 whatever order a sum takes. Widths (1,1), (3,2),
    (1,0), (2,2), (4,4) and (24,24), on slabs of 2, 4, 8 and 16 rows and
    on an uneven layout, over space 2 and 4 (and 2 x 2, whose data
    indices hold different images), with each fill; where every slab is
    at least as high as the widths, also without a layout (the
    neighbours' transport of the UNet's convolutions).
  * The buffer holds the rows exchanged and no more.
  * `halo_rows` passes torch.autograd.gradcheck in float64 on 2 and 4
    ranks as a function of the whole image, with halos wider than a slab.
"""

import functools
import pathlib
import shutil
import tempfile

import pytest
import torch

import torch_dist as td
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu_torch.parallel import spatial

pytestmark = pytest.mark.usefixtures("single_thread")

WIDTHS = [(1, 1), (3, 2), (1, 0), (2, 2), (4, 4), (24, 24)]
FILLS = ["zeros", "neg_inf", "edge"]
GRADCHECK = {2: "zeros", 4: "edge"}             # world -> fill


def layouts(space):
    """Row layouts (each rank's (start, stop)): equal slabs of 2, 4, 8 and
    16 rows, and an uneven one."""
    out = [tuple((j * r, (j + 1) * r) for j in range(space))
           for r in (2, 4, 8, 16)]
    sizes = (4, 2) if space == 2 else (4, 4, 2, 2)
    starts = [sum(sizes[:j]) for j in range(space)]
    out.append(tuple((a, a + r) for a, r in zip(starts, sizes)))
    return out


def _image(data_index, height, n=2, c=3, w=5):
    g = torch.Generator().manual_seed(100 + data_index + 7 * height)
    return torch.randint(-50, 50, (n, c, height, w), generator=g).float()


def _upstream(data_index, space_index, shape):
    g = torch.Generator().manual_seed(200 + 10 * data_index + space_index)
    return torch.randint(-50, 50, shape, generator=g).float()


def cases(space):
    """(layout, top, bottom, fill, with the layout or not)."""
    out = []
    for bounds in layouts(space):
        low = min(b - a for a, b in bounds)
        for top, bottom in WIDTHS:
            for fill in FILLS:
                out.append((bounds, top, bottom, fill, True))
                if max(top, bottom) <= low:
                    out.append((bounds, top, bottom, fill, False))
    return out


def run_halos(mesh):
    """Every case of `cases` on this rank, then (on a 1 x space mesh) the
    gradcheck of `run_gradcheck` with halos wider than a slab."""
    res = []
    for bounds, top, bottom, fill, given in cases(mesh.space):
        a, b = bounds[mesh.space_index]
        x = _image(mesh.data_index, bounds[-1][1])[:, :, a:b]
        x = x.clone().requires_grad_()
        y = spatial.halo_rows(x, mesh, top, bottom, fill,
                              bounds if given else None)
        y.backward(_upstream(mesh.data_index, mesh.space_index, y.shape))
        res.append((y.detach(), x.grad))
    if mesh.space == mesh.world:
        res.append(run_gradcheck(mesh, 3, 2, GRADCHECK[mesh.world], 2))
    return res


@functools.lru_cache(maxsize=None)
def halo_runs(world, space):
    tmp = pathlib.Path(tempfile.mkdtemp())
    try:
        return td.run_ranks(tmp, world, run_halos, spatial=space)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def padded_rows(height, a, b, top, bottom, fill):
    """The global rows of [a - top, b + bottom) after the fill: the row
    index (clamped for "edge"), or None past an edge."""
    out = []
    for g in range(a - top, b + bottom):
        if not 0 <= g < height:
            g = min(max(g, 0), height - 1) if fill == "edge" else None
        out.append(g)
    return out


@pytest.mark.parametrize("world,space", [(2, 2), (4, 4), (4, 2)])
@pytest.mark.parametrize("fill", FILLS)
def test_halo_is_a_copy(world, space, fill):
    res = halo_runs(world, space)
    value = float("-inf") if fill == "neg_inf" else 0.0
    checked = 0
    for i, (bounds, top, bottom, f, given) in enumerate(cases(space)):
        if f != fill:
            continue
        height = bounds[-1][1]
        for d in range(world // space):
            full = _image(d, height)
            grad = torch.zeros_like(full)
            for s in range(space):
                a, b = bounds[s]
                rows = padded_rows(height, a, b, top, bottom, fill)
                want = torch.stack([full[:, :, g] if g is not None else
                                    torch.full_like(full[:, :, 0], value)
                                    for g in rows], dim=2)
                got, _ = res[d * space + s][i]
                assert torch.equal(got, want), (bounds, top, bottom, s)
                up = _upstream(d, s, want.shape)
                for j, g in enumerate(rows):
                    if g is not None:
                        grad[:, :, g] += up[:, :, j]
            for s in range(space):
                a, b = bounds[s]
                _, gx = res[d * space + s][i]
                assert torch.equal(gx, grad[:, :, a:b]), (bounds, top, s)
            checked += 1
    assert checked >= 30


def test_buffer_holds_the_rows_exchanged():
    # the UNet's 1-row halos over 4 ranks: the 6 edge rows of 3 boundaries
    assert spatial._neighbour_plan(1, 4, 8, 1, 1, "zeros").slots == 6
    quarters = ((0, 8), (8, 16), (16, 24), (24, 32))
    assert spatial._layout_plan(quarters, 1, 1, 1, "zeros").slots == 6
    # the stem's (3, 2) over 2 ranks: rows 13-15 down, 16-17 up
    plan = spatial._layout_plan(((0, 16), (16, 32)), 0, 3, 2, "zeros")
    assert plan.slots == 5 and plan.send == (13, 14, 15)
    # DeepLab's ASPP, 24 rows each way over 4 slabs of 8: every row
    assert spatial._layout_plan(quarters, 0, 24, 24, "zeros").slots == 32
    # the edge fill repeats the image's edge row, here on another rank
    plan = spatial._layout_plan(((0, 2), (2, 4)), 1, 3, 0, "edge")
    assert plan.slots == 2 and plan.send == ()


def run_gradcheck(mesh, top, bottom, fill, rows):
    """halo_rows as a function of the whole image: each rank takes the
    replicated input (`_Replicated` of tests/test_torch_spatial.py), keeps
    its rows, and places its haloed slab in its own entry of a stacked
    output that sum_replicated adds up over the ranks."""
    from test_torch_spatial import _Replicated
    bounds = tuple((j * rows, (j + 1) * rows) for j in range(mesh.space))
    a, b = bounds[mesh.space_index]
    g = torch.Generator().manual_seed(7)
    x = torch.randn((1, 2, bounds[-1][1], 3), generator=g,
                    dtype=torch.float64, requires_grad=True)

    def whole(x):
        y = spatial.halo_rows(_Replicated.apply(x)[:, :, a:b], mesh, top,
                              bottom, fill, bounds)
        out = y.new_zeros((mesh.space,) + y.shape)
        out[mesh.space_index] = y
        return mesh.sum_replicated(out)

    return torch.autograd.gradcheck(whole, (x,))


@pytest.mark.parametrize("world", [2, 4])
def test_halo_gradcheck_wider_than_a_slab(world):
    assert [r[-1] for r in halo_runs(world, world)] == [True] * world
