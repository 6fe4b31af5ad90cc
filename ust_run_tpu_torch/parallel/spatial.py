"""The space axis's halo exchange and the operations of the models on a
row slab.

On a mesh with a space axis (parallel/mesh.py) each rank holds a
contiguous run of every image's rows. An operation whose window spans
several rows then needs rows of other slabs: `halo_rows` adds `top` rows
above the slab and `bottom` rows below it, taken from whichever ranks own
them, however far away, and filled past the image's top and bottom edges
with zeros (a convolution's padding), -inf (a max pool's) or the edge row
repeated (a bilinear resize's clamp). The operations below run on the
haloed slab and compute the whole-image operation restricted to this
rank's rows: `conv` (any kernel, stride and dilation of an nn.Conv2d),
`conv_sum` (DeepLab's ASPP), `max_pool2d`, `upsample2x` (bilinear x2,
align_corners=False) and `resize_align_corners` (on the image's global
sampling grid); `conv3x3` is the UNet's. The JAX package leaves this to
GSPMD's spatial partitioner (ust_run_tpu/parallel/mesh.py:11-13).

Transport is one sum all-reduce over the space group of a zero buffer
that holds the rows exchanged and nothing else: each owner fills its rows
forward, and each consumer its halo rows' gradients backward, which the
owners then add to their rows (every fold of gradients a product with a
0/1 matrix made once per plan: index_add_ on CUDA adds with atomics, in
an order that changes from run to run). It is the one code path that Gloo on CUDA
tensors, Gloo on the CPU and NCCL all take (Gloo offers only `all_reduce`
and `broadcast` for CUDA tensors). Forward, each position has one
non-zero contributor, so the sum is a copy. 16-bit values travel as
float32, which holds them exactly.

Which rows are exchanged is a plan made once per shape:
  * given the layer's row layout (`layout`: every space rank's rows, from
    the input's 16-row blocks), every row that some rank needs from
    another, once each; when the halo covers most of the image the buffer
    holds most of it (DeepLab's ASPP over 4 ranks: all of it);
  * without one (`halo_rows(x, mesh)`, the UNet's 3x3 convolutions), the
    neighbours' edge rows: each slab must hold at least `top` and
    `bottom` rows, and a buffer of (space - 1) x (top + bottom) rows
    carries them.
"""

import collections
import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ust_run_tpu_torch.parallel.mesh import ROW_BLOCK, wire_dtype

FILLS = {"zeros": 0.0, "neg_inf": float("-inf"), "edge": 0.0}

# One halo's exchange for one rank. The halo rows are read from a pool
# [its own rows `local` | the buffer's `slots` rows | one fill row] at the
# positions `idx` (top rows, then bottom rows); the rank writes its rows
# `send` to the buffer's rows `send_slots`.
_Plan = collections.namedtuple(
    "_Plan", "top bottom slots send send_slots local idx")


def _make_plan(top, bottom, slots, send, sends, local, reads):
    """A _Plan from `reads`: per halo row, ("slot", i), ("local", row) or
    None (the fill)."""
    local = sorted(set(local))
    pos = {r: i for i, r in enumerate(local)}
    fill = len(local) + slots
    idx = tuple(fill if src is None else
                pos[src[1]] if src[0] == "local" else len(local) + src[1]
                for src in reads)
    return _Plan(top, bottom, slots, tuple(send), tuple(sends), tuple(local),
                 idx)


@functools.lru_cache(maxsize=None)
def _neighbour_plan(me, space, h, top, bottom, fill):
    """The neighbours' edge rows: boundary j (between ranks j and j + 1)
    owns slots j*(top+bottom) + [0, top), rank j's last `top` rows, and
    + [top, top+bottom), rank j+1's first `bottom` rows."""
    if h < max(top, bottom):
        raise ValueError(f"a slab of {h} rows cannot give a halo of "
                         f"{max(top, bottom)} rows to its neighbours alone: "
                         f"pass the layer's row layout")
    per = top + bottom
    send, sends, reads, local = [], [], [], []
    if me < space - 1:
        send += range(h - top, h)
        sends += range(me * per, me * per + top)
    if me > 0:
        send += range(bottom)
        sends += range((me - 1) * per + top, me * per)
    edge = fill == "edge"
    for i in range(top):
        if me > 0:
            reads.append(("slot", (me - 1) * per + i))
        else:
            reads.append(("local", 0) if edge else None)
    for i in range(bottom):
        if me < space - 1:
            reads.append(("slot", me * per + top + i))
        else:
            reads.append(("local", h - 1) if edge else None)
    local = [src[1] for src in reads if src and src[0] == "local"]
    return _make_plan(top, bottom, (space - 1) * per, send, sends, local,
                      reads)


@functools.lru_cache(maxsize=None)
def _layout_plan(bounds, me, top, bottom, fill):
    """Every row that some rank's halo takes from another rank, once each
    and in order, given every rank's rows `bounds` ((start, stop) each):
    rows past the image's edges are the fill (or, for "edge", the edge
    row, which may lie on another rank)."""
    height = bounds[-1][1]

    def needs(a, b):
        rows = []
        for g in list(range(a - top, a)) + list(range(b, b + bottom)):
            if not 0 <= g < height:
                g = min(max(g, 0), height - 1) if fill == "edge" else None
            rows.append(g)
        return rows

    exchanged = sorted({g for a, b in bounds for g in needs(a, b)
                        if g is not None and not a <= g < b})
    slot = {g: i for i, g in enumerate(exchanged)}
    a, b = bounds[me]
    send = [g - a for g in exchanged if a <= g < b]
    sends = [slot[g] for g in exchanged if a <= g < b]
    reads = [None if g is None else ("local", g - a) if a <= g < b
             else ("slot", slot[g]) for g in needs(a, b)]
    local = [src[1] for src in reads if src and src[0] == "local"]
    return _make_plan(top, bottom, len(exchanged), send, sends, local, reads)


_CONSTS = {}


def _const(key, device, make):
    """make() as a tensor on `device`, made once per `key`: the plans'
    indices and the resize's matrices, which would otherwise cross from
    the host at every call."""
    key = (key, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(make(), device=device)
    return _CONSTS[key]


def _index(rows, device):
    """`rows` (a tuple) as an int64 tensor on `device`."""
    return _const(rows, device, lambda: np.asarray(rows, np.int64))


class _Halo(torch.autograd.Function):
    """(N, C, h, W) -> (N, C, top + h + bottom, W) by `plan`. Backward
    returns each halo row's gradient to the rank that owns the row, which
    adds it to that row."""

    @staticmethod
    def forward(ctx, x, mesh, plan, fill):
        ctx.mesh, ctx.plan = mesh, plan
        n, c, h, w = x.shape
        dev, wire = x.device, wire_dtype(x.dtype)
        buf = x.new_zeros((plan.slots, n, c, w), dtype=wire)
        if plan.send:
            buf.index_copy_(0, _index(plan.send_slots, dev),
                            x.index_select(2, _index(plan.send, dev))
                            .permute(2, 0, 1, 3).to(wire))
        if plan.slots:
            dist.all_reduce(buf, group=mesh.space_group)
        pool = [buf.permute(1, 2, 0, 3).to(x.dtype),
                x.new_full((n, c, 1, w), FILLS[fill])]
        if plan.local:
            pool.insert(0, x.index_select(2, _index(plan.local, dev)))
        halo = torch.cat(pool, dim=2).index_select(2, _index(plan.idx, dev))
        # the model's layout: NCHW-shaped, channels_last in memory
        fmt = torch.channels_last if x.stride(1) == 1 and c > 1 \
            else torch.contiguous_format
        top = plan.top
        out = torch.empty((n, c, top + h + plan.bottom, w), dtype=x.dtype,
                          device=dev, memory_format=fmt)
        out[:, :, :top] = halo[:, :, :top]
        out[:, :, top:top + h] = x
        out[:, :, top + h:] = halo[:, :, top:]
        return out

    @staticmethod
    def backward(ctx, grad):
        mesh, plan = ctx.mesh, ctx.plan
        top, dev = plan.top, grad.device
        h = grad.shape[2] - top - plan.bottom
        g_halo = torch.cat([grad[:, :, :top], grad[:, :, top + h:]], dim=2)
        local, slots, recv = (_const(("fold", i, plan, h), dev,
                                     lambda: _fold(plan, h)[i])
                              for i in range(3))
        gx = grad[:, :, top:top + h] + rows_product(local, g_halo)
        if plan.slots:
            wire = wire_dtype(grad.dtype)
            buf = rows_product(slots, g_halo.to(wire)).contiguous()
            dist.all_reduce(buf, group=mesh.space_group)
            gx = gx + rows_product(recv, buf).to(gx.dtype)
        return gx, None, None, None


@functools.lru_cache(maxsize=None)
def _fold(plan, h):
    """The halo's backward as three 0/1 matrices over rows (the plan is
    fixed per layout, so they are made once): (h, R) adding each of the
    R = top + bottom halo rows' gradients to the local row it copied,
    (slots, R) placing the others in the exchange buffer, and (h, slots)
    adding the summed buffer's slots to the rows this rank sent. Products
    with them sum in a fixed order, where index_add_ on CUDA adds with
    atomics."""
    nl, halo = len(plan.local), len(plan.idx)
    pool = np.zeros((nl + plan.slots + 1, halo), np.float32)
    pool[list(plan.idx), np.arange(halo)] = 1.0       # the fill row: dropped
    local = np.zeros((h, nl), np.float32)
    local[list(plan.local), np.arange(nl)] = 1.0
    recv = np.zeros((h, plan.slots), np.float32)
    np.add.at(recv, (list(plan.send), list(plan.send_slots)), 1.0)
    return local @ pool[:nl], pool[nl:nl + plan.slots], recv


def rows_product(m, x):
    """y[n, c, i, w] = sum over r of m[i, r] x[n, c, r, w]: a matrix over
    the rows of an (N, C, R, W) tensor, as one matrix product on its
    channels-last rows; (N, C, I, W), channels_last in memory."""
    n, c, r, w = x.shape
    y = torch.matmul(m.to(x.dtype), x.permute(0, 2, 3, 1).reshape(n, r,
                                                                  w * c))
    return y.reshape(n, -1, w, c).permute(0, 3, 1, 2)


def resize_by(x, my, mw):
    """x (N, C, H, W) resized by interpolation matrices: `my` (H2, H) over
    the rows, then `mw` (W2, W) over the columns (the JAX package's two
    einsums), each one matrix product on the channels-last rows, whose
    backward is two more products, with no atomics. (N, C, H2, W2),
    channels_last in memory."""
    y = rows_product(my, x)
    n, c, h2, w = y.shape
    z = torch.matmul(mw.to(x.dtype), y.permute(0, 2, 3, 1).reshape(
        n * h2, w, c))
    return z.reshape(n, h2, -1, c).permute(0, 3, 1, 2)


def halo_rows(x, mesh, top=1, bottom=1, fill="zeros", bounds=None):
    """x (N, C, h, W), this rank's rows -> (N, C, top + h + bottom, W):
    the `top` rows above the slab and the `bottom` rows below it, from the
    ranks that own them, and `fill` past the image's edges ("zeros",
    "neg_inf" or "edge": the edge row repeated); differentiable. `bounds`
    is the layer's row layout (`layout`); without it, the rows come from
    the neighbours alone."""
    if fill not in FILLS:
        raise ValueError(f"fill {fill!r} is not one of {sorted(FILLS)}")
    if top == bottom == 0:
        return x
    plan = _neighbour_plan(mesh.space_index, mesh.space, x.shape[2], top,
                           bottom, fill) if bounds is None \
        else _layout_plan(bounds, mesh.space_index, top, bottom, fill)
    return _Halo.apply(x, mesh, plan, fill)


def conv3x3(x, weight, mesh):
    """`F.conv2d(x, weight, padding=1)` of the whole image, restricted to
    this rank's rows: the haloed slab convolved with padding (0, 1)."""
    return F.conv2d(halo_rows(x, mesh), weight, padding=(0, 1))


# ---------------------------------------------------------------------------
# the zoo's operations on a slab


class SlabAware(nn.Module):
    """A module that runs its operations of kernel > 1 on a row slab when a
    mesh is bound (parallel.bind_mesh) and a call's GroupSizes carry the
    image's height."""

    mesh = None


def slab_mesh(module, sizes):
    """The mesh `module` runs a call on as a row slab, or None when the
    call is on whole images (`sizes` carries no height). A slab needs the
    mesh bound: a module without one would zero-pad every slab's edges."""
    if getattr(sizes, "height", None) is None:
        return None
    assert module.mesh is not None, \
        "a row slab needs the mesh bound (parallel.bind_mesh)"
    return module.mesh


def layout(mesh, sizes, w, h=None):
    """Every space rank's rows (start, stop) of a layer of width w, in the
    layer's global rows: the input's blocks of ROW_BLOCK rows scaled to
    the layer (GroupedBatchNorm's slab_hw rule: the layer spans height *
    w // width rows). With `h`, the rows this rank holds, checked."""
    height = sizes.height * w // sizes.width
    per, rest = divmod(ROW_BLOCK * height, sizes.height)
    if rest:
        raise ValueError(f"a layer of {height} rows cuts the input's "
                         f"{ROW_BLOCK}-row blocks into fractions of a row")
    bounds = tuple((sl.start // ROW_BLOCK * per, sl.stop // ROW_BLOCK * per)
                   for sl in (mesh.row_slice(sizes.height, j)
                              for j in range(mesh.space)))
    a, b = bounds[mesh.space_index]
    assert h is None or b - a == h, (bounds, mesh.space_index, h)
    return bounds


def _window_rows(k, stride, padding, dilation=1):
    """The halo (top, bottom) of a sliding window of k rows on a slab
    that starts on a multiple of `stride`: output row i reads input rows
    i*stride - padding + dilation*[0, k)."""
    bottom = dilation * (k - 1) - padding - stride + 1
    assert bottom >= 0, (k, stride, padding, dilation)
    return padding, bottom


def _check_stride(bounds, me, stride):
    a, b = bounds[me]
    assert a % stride == 0 and b % stride == 0, (bounds, stride)


def conv(module, x, mesh=None, sizes=None):
    """`module(x)` (an nn.Conv2d with zero padding) of the whole image,
    restricted to this rank's rows when `mesh` is given: the slab between
    its halo rows, convolved with the padding in width only."""
    if mesh is None:
        return module(x)
    (k, _), (s, _), (p, pw), (d, _) = (module.kernel_size, module.stride,
                                       module.padding, module.dilation)
    bounds = layout(mesh, sizes, x.shape[3], x.shape[2])
    _check_stride(bounds, mesh.space_index, s)
    top, bottom = _window_rows(k, s, p, d)
    return F.conv2d(halo_rows(x, mesh, top, bottom, "zeros", bounds),
                    module.weight, module.bias, (s, module.stride[1]),
                    (0, pw), module.dilation)


def conv_sum(modules, x, mesh, sizes):
    """The sum of the stride-1 nn.Conv2d `modules` (each at its own
    dilation, zero padding as wide) of one input, in order, restricted to
    this rank's rows: one halo as wide as the widest padding, shared by
    all (DeepLab's ASPP: 24 rows, not four exchanges), each convolving its
    rows of it."""
    reach = max(m.padding[0] for m in modules)
    bounds = layout(mesh, sizes, x.shape[3], x.shape[2])
    xh = halo_rows(x, mesh, reach, reach, "zeros", bounds)
    h, out = x.shape[2], None
    for m in modules:
        p = m.padding[0]
        assert m.stride[0] == 1 and _window_rows(
            m.kernel_size[0], 1, p, m.dilation[0]) == (p, p), m
        y = F.conv2d(xh[:, :, reach - p:reach + h + p], m.weight, m.bias,
                     1, (0, m.padding[1]), m.dilation)
        out = y if out is None else out + y
    return out


def max_pool2d(x, kernel, stride, padding, mesh=None, sizes=None):
    """`F.max_pool2d(x, kernel, stride, padding)` of the whole image,
    restricted to this rank's rows when `mesh` is given: halo rows filled
    with -inf past the image's edges, as the pool's own padding."""
    if mesh is None:
        return F.max_pool2d(x, kernel, stride=stride, padding=padding)
    bounds = layout(mesh, sizes, x.shape[3], x.shape[2])
    _check_stride(bounds, mesh.space_index, stride)
    top, bottom = _window_rows(kernel, stride, padding)
    return F.max_pool2d(halo_rows(x, mesh, top, bottom, "neg_inf", bounds),
                        kernel, stride=stride, padding=(0, padding))


def bilinear_matrix(n_out, n_in):
    """(n_out, n_in) weights of the bilinear enlargement with half-pixel
    centres (nn.Upsample(mode='bilinear', align_corners=False);
    jax.image.resize's "bilinear" when n_out >= n_in): output i samples
    input position (i + 0.5) * n_in / n_out - 0.5, clamped to the edge
    rows, as jax.image.resize's weights renormalised over the rows inside
    the image."""
    assert n_out >= n_in, (n_out, n_in)
    pos = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), max(n_in - 2, 0))
    frac = pos - lo
    m = np.zeros((n_out, n_in), np.float64)
    m[np.arange(n_out), lo] = 1.0 - frac
    if n_in > 1:
        m[np.arange(n_out), lo + 1] += frac
    return m.astype(np.float32)


def resize_bilinear(x, h2, w2):
    """F.interpolate(x, (h2, w2), mode='bilinear', align_corners=False) of
    an (N, C, h, w) tensor enlarged to h2 x w2 (jax.image.resize's
    "bilinear"), as two matrix products (`resize_by`)."""
    h, w = x.shape[2:]
    dev = x.device
    return resize_by(x, _const(("bilinear", h2, h), dev,
                               lambda: bilinear_matrix(h2, h)),
                     _const(("bilinear", w2, w), dev,
                            lambda: bilinear_matrix(w2, w)))


def upsample2x(x, mesh=None, sizes=None):
    """nn.Upsample(scale_factor=2, mode='bilinear', align_corners=False) of
    the whole image, as two matrix products (`resize_bilinear`),
    restricted to this rank's rows when `mesh` is given: one halo row each
    side (the edge row repeated past the image's edges, the resize's own
    clamp) and the haloed slab's interpolation rows cropped to the slab's
    own, so no output row reads the slab's clamped edges."""
    h, w = x.shape[2:]
    if mesh is None:
        return resize_bilinear(x, 2 * h, 2 * w)
    bounds = layout(mesh, sizes, w, h)
    my = _const(("bilinear slab", h), x.device,
                lambda: bilinear_matrix(2 * h + 4, h + 2)[2:-2])
    mw = _const(("bilinear", 2 * w, w), x.device,
                lambda: bilinear_matrix(2 * w, w))
    return resize_by(halo_rows(x, mesh, 1, 1, "edge", bounds), my, mw)


def interp_matrix(n_out, n_in):
    """(n_out, n_in) align-corners linear interpolation weights (the JAX
    package's deeplab._interp_matrix): output i samples input position
    i*(n_in-1)/(n_out-1)."""
    if n_out == 1 or n_in == 1:
        m = np.zeros((n_out, n_in), np.float32)
        m[:, 0] = 1.0
        return m
    pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
    frac = (pos - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] = 1.0 - frac
    m[np.arange(n_out), lo + 1] = frac
    return m


def align_matrix(n_out, n_in, device):
    """interp_matrix(n_out, n_in) on `device`, made once."""
    return _const(("align", n_out, n_in), device,
                  lambda: interp_matrix(n_out, n_in))


def resize_align_corners(x, h2, w2, mesh, sizes):
    """The bilinear align_corners=True resize of the whole image to a
    layer of h2 x w2 per rank (DeepLab's logits at the input's size),
    restricted to this rank's rows: the image's interpolation rows
    interp_matrix(H2, H1)[a2:b2] on the input rows they reach (halo rows
    from the ranks that own them), then the width's. Not F.interpolate on
    the slab, which would map the slab's corners instead of the
    image's."""
    w1 = x.shape[3]
    bounds1 = layout(mesh, sizes, w1, x.shape[2])
    bounds2 = layout(mesh, sizes, w2, h2)
    top, bottom, my = _resize_rows(bounds1, bounds2, mesh.space_index)
    xh = halo_rows(x, mesh, top, bottom, "zeros", bounds1)
    my = _const(("rows", bounds1, bounds2, mesh.space_index), x.device,
                lambda: my)
    return resize_by(xh, my, align_matrix(w2, w1, x.device))


@functools.lru_cache(maxsize=None)
def _resize_rows(bounds1, bounds2, me):
    """The halo (top, bottom) that every rank's output rows reach, the
    widest over the ranks (one exchange needs the same widths on all),
    and this rank's interpolation rows over its haloed slab's rows."""
    m = interp_matrix(bounds2[-1][1], bounds1[-1][1])
    top = bottom = 0
    for (a1, b1), (a2, b2) in zip(bounds1, bounds2):
        reach = np.flatnonzero(m[a2:b2].any(axis=0))
        top = max(top, a1 - reach[0])
        bottom = max(bottom, reach[-1] + 1 - b1)
    (a1, b1), (a2, b2) = bounds1[me], bounds2[me]
    rows = np.zeros((b2 - a2, top + b1 - a1 + bottom), np.float32)
    lo, hi = max(a1 - top, 0), min(b1 + bottom, bounds1[-1][1])
    rows[:, lo - (a1 - top):hi - (a1 - top)] = m[a2:b2, lo:hi]
    return int(top), int(bottom), rows
