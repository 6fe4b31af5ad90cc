"""GroupedBatchNorm's passes (ust_run_tpu_torch/ops/grouped_bn.py,
csrc/grouped_bn.cu). On the CPU: the reduction plan and the no-gradient
path. On a card (`cuda` marker; `python -m pytest --noconftest -m cuda
tests/test_torch_grouped_bn.py`): each of the four kernels against its
plain version at the main path's shapes, two runs bit-equal, a captured
graph's replays equal to eager calls, the launch counts, and the layouts
the kernels refuse. The JAX parity of the whole Function is in
test_torch_models.py. This file imports no JAX."""

import numpy as np
import pytest
import torch

from torch_threads import single_thread  # noqa: F401
from ust_run_tpu_torch.models.layers import GroupedBatchNorm
from ust_run_tpu_torch.ops import grouped_bn as gbn

pytestmark = pytest.mark.usefixtures("single_thread")

# (n, c, h, w, dtype, group sizes): the UNet's L1 student call, its
# deepest layer in the teacher's call, an R101 layer-3 student call
CARD_SHAPES = [(21, 64, 256, 256, torch.bfloat16, (4, 4, 4, 4, 4, 1)),
               (12, 1024, 16, 16, torch.bfloat16, (4, 4, 4)),
               (21, 1024, 32, 32, torch.float32, (4, 4, 4, 4, 4, 1))]


@pytest.mark.parametrize("n,c,hw,dtype", [
    (21, 64, 65536, torch.bfloat16), (12, 1024, 256, torch.bfloat16),
    (21, 1024, 1024, torch.float32), (12, 2048, 1024, torch.float32),
    (4, 96, 4096, torch.bfloat16), (2, 8, 30, torch.float32)])
def test_plan_covers_the_layer_and_fills_the_card(n, c, hw, dtype):
    """Every channel and row is in one tile and one slab; the blocks fill
    the card (gbn.BLOCKS) unless that would leave a thread fewer than
    MIN_ROWS rows of a slab."""
    p = gbn.plan(n, c, hw, dtype)
    cv = c // gbn.vec(dtype)
    assert 1 <= p.tx <= 32 and p.tx * p.ty <= gbn.THREADS
    assert (p.tiles - 1) * p.tx < cv <= p.tiles * p.tx
    assert (p.slabs - 1) * p.rows < hw <= p.slabs * p.rows
    blocks = n * p.tiles * p.slabs
    assert blocks >= gbn.BLOCKS or p.slabs == 1 \
        or p.rows < 2 * p.ty * gbn.MIN_ROWS
    if p.slabs > 1:
        assert p.rows >= p.ty * gbn.MIN_ROWS


@pytest.mark.parametrize("relu", [False, True])
def test_no_grad_path_records_nothing(relu):
    """Under no_grad (the teacher) the layer gives the Function's output
    and running statistics and records no graph."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 8, 5, 4), generator=g) * 2 + 0.5
    bns = [GroupedBatchNorm(8), GroupedBatchNorm(8)]
    with torch.no_grad():
        y0 = bns[0](x, groups=3, relu=relu)
    y1 = bns[1](x.clone().requires_grad_(), groups=3, relu=relu)
    assert y0.grad_fn is None and y1.grad_fn is not None
    assert torch.equal(y0, y1.detach())
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(bns[0], name), getattr(bns[1], name))


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _groups(sizes):
    seg = np.repeat(np.arange(len(sizes)), sizes)
    off = np.concatenate([[0], np.cumsum(sizes)])
    return gbn.Groups(torch.as_tensor(seg, dtype=torch.int32).cuda(),
                      torch.as_tensor(off, dtype=torch.int32).cuda())


def _operands(n, c, h, w, dtype, sizes, seed=0):
    """x, dy (channels_last on the card), per-group inv, shift and
    per-sample ds1, ds2, drawn on the CPU from `seed`."""
    g = torch.Generator().manual_seed(seed)
    cl = dict(memory_format=torch.channels_last)
    x = (torch.randn((n, c, h, w), generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn((n, c, h, w), generator=g).to(dtype)
    k = len(sizes)
    inv = torch.rand((k, c), generator=g) + 0.5
    shift = torch.randn((k, c), generator=g) * 0.3 + 0.5
    ds1 = torch.randn((n, c), generator=g) * 1e-3
    ds2 = torch.randn((n, c), generator=g) * 1e-3
    return (x.cuda().contiguous(**cl), dy.cuda().contiguous(**cl),
            inv.cuda(), shift.cuda(), ds1.cuda(), ds2.cuda(), _groups(sizes))


def _close_sums(got, want, scale):
    """float32 sums of up to 65536 terms a sample in another order: within
    1e-5 of the sum of the terms' magnitudes."""
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-30).all()), \
        (got - want).abs().max().item()


def _close_elementwise(got, want, scale):
    """One rounding to x's type from float32 arithmetic that may contract
    a product and a sum into one FMA: within one ulp of the plain value
    plus 4 float32 ulp of the terms' magnitudes (near-cancelling sums)."""
    ulp = torch.finfo(got.dtype).eps * want.float().abs()
    tol = ulp + 4 * torch.finfo(torch.float32).eps * scale
    assert bool(((got.float() - want.float()).abs() <= tol).all()), \
        (got.float() - want.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=["unet_l1", "unet_l5", "r101_l3"])
def test_kernels_match_plain_on_card(shape):
    """Each kernel against its plain version on the same card tensors, the
    ReLU on and off, each launch counted once."""
    _card()
    x, dy, inv, shift, ds1, ds2, groups = _operands(*shape)
    xf = x.float()
    before = gbn.launches
    s1, s2 = gbn.moments(x)
    p1, p2 = gbn.moments_plain(x)
    _close_sums(s1, p1, xf.abs().sum(dim=(2, 3)))
    _close_sums(s2, p2, (xf * xf).sum(dim=(2, 3)))
    seg = groups.seg.long()
    scale_y = (xf * inv[seg][:, :, None, None]).abs() \
        + shift[seg][:, :, None, None].abs()
    for relu in (False, True):
        y = gbn.apply(x, inv, shift, groups, relu)
        _close_elementwise(y, gbn.apply_plain(x, inv, shift, groups, relu),
                           scale_y)
        a, b = gbn.grad_sums(dy, y, x, groups, relu)
        pa, pb = gbn.grad_sums_plain(dy, y, x, groups, relu)
        g = gbn._masked(dy, y, relu)
        mag = torch.zeros_like(pa).index_add_(0, seg, g.abs().sum((2, 3)))
        _close_sums(a, pa, mag)
        mag = torch.zeros_like(pb).index_add_(
            0, seg, (g * xf).abs().sum((2, 3)))
        _close_sums(b, pb, mag)
        dx = gbn.input_grad(dy, y, x, inv, groups, ds1, ds2, relu)
        want = gbn.input_grad_plain(dy, y, x, inv, groups, ds1, ds2, relu)
        scale = (g * inv[seg][:, :, None, None]).abs() \
            + ds1[:, :, None, None].abs() \
            + (2 * xf * ds2[:, :, None, None]).abs()
        _close_elementwise(dx, want, scale)
    torch.cuda.synchronize()
    assert gbn.launches == before + 7


def _step(bn, x, r, sizes, relu):
    """A train-mode call of `bn` on the groups `sizes` and the gradient of
    sum(y * r): (y, dx, dweight, dbias, running mean, running var)."""
    y = bn(x, group_sizes=sizes, relu=relu)
    dx, dw, db = torch.autograd.grad((y.float() * r).sum(),
                                     [x, bn.weight, bn.bias])
    return y, dx, dw, db, bn.running_mean.clone(), bn.running_var.clone()


def _layer(c):
    bn = GroupedBatchNorm(c).cuda()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.1)
    return bn


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES[1:], ids=["unet_l5", "r101_l3"])
def test_two_runs_and_graph_replays_are_bit_equal_on_card(shape):
    """The layer's forward and backward twice from one state: equal bit for
    bit. Then the same step captured as a CUDA graph and replayed 3 times:
    each replay equal to the eager call, the launches counted as
    captured (4 a step: moments, apply, gradient sums, input gradient)
    and not run."""
    _card()
    n, c, h, w, dtype, sizes = shape
    x, r = _operands(*shape, seed=1)[:2]
    x.requires_grad_()
    r = r.float()
    runs = []
    for _ in range(2):
        bn = _layer(c)
        runs.append(_step(bn, x, r, sizes, True))
    for a, b in zip(*runs):
        assert torch.equal(a, b)

    bn = _layer(c)
    static_x = x.detach().clone().requires_grad_()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _step(bn, static_x, r, sizes, True)        # warm-up: constants
    torch.cuda.current_stream().wait_stream(side)
    bn = _layer(c)
    graph = torch.cuda.CUDAGraph()
    launches, captured = gbn.launches, gbn.captured
    with torch.cuda.graph(graph):
        out = _step(bn, static_x, r, sizes, True)
    assert gbn.captured == captured + 4 and gbn.launches == launches
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out[:4], runs[0][:4]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_layouts_the_kernels_refuse_raise_on_card():
    """A contiguous-NCHW CUDA input, a float16 one and channels not a
    multiple of 16 bytes raise; nothing falls back to the plain version."""
    _card()
    bn = _layer(64)
    x = torch.randn((4, 64, 8, 8), device="cuda")
    with pytest.raises(ValueError, match="channels_last"):
        bn(x, groups=2)
    cl = dict(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels_last"):
        bn(x.half().contiguous(**cl), groups=2)
    with pytest.raises(ValueError, match="multiple"):
        _layer(6)(torch.randn((4, 6, 8, 8), device="cuda")
                  .contiguous(**cl), groups=2)
    # the same layer takes the channels_last input
    assert bn(x.contiguous(**cl), groups=2).shape == x.shape
