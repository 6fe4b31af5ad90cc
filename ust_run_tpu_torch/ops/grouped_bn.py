"""GroupedBatchNorm's train-mode forward and backward (+ReLU) as one
autograd Function on four passes (csrc/grouped_bn.cu). The JAX package
has no kernel here: XLA fuses its jnp BatchNorm (see the source's note).

    moments      s1, s2 = sum_hw x, sum_hw x^2         (n, c) float32
    apply        y = x * inv[seg] - shift[seg], relu    x's dtype
    grad_sums    a, b = sum dy', sum dy' x               (g, c) per group
    input_grad   dx = dy' * inv[seg] + ds1 + 2 x ds2    x's dtype

dy' is dy where the ReLU's output is > 0 (dy without the ReLU). Between
the passes, the caller's group arithmetic `coeffs(s1, s2, weight, bias)
-> (inv, shift, mean, var)`, each (g, c) float32, runs as PyTorch ops: in
the forward under autograd on detached leaves, so that the backward gets
ds1, ds2 and the parameters' gradients from (d inv, d shift) = (b, -a)
through that graph, collectives included (models/layers.py).

Each pass launches the CUDA kernel for a CUDA tensor: 4-D, channels_last
contiguous, bf16 or float32, c a multiple of 8 (bf16) or 4 (float32),
16-byte aligned. Any other CUDA tensor raises; there is no fallback. The
plain PyTorch version of each pass (`*_plain`, the same arithmetic) runs
only for a CPU tensor, so the CPU tests run the Function's forward and its
hand-derived backward as the kernels compute them.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

# Kernel launches that ran (a plain count, reset by callers that want to
# show a run went through the kernels): one for each pass a CUDA tensor
# takes outside a CUDA graph capture, and the passes a replayed graph runs
# (added by semisup/step.py's StepGraph). A pass recorded into a capture
# runs only on replay: `captured` counts those.
launches = 0
captured = 0

THREADS = 256
BLOCKS = 132 * 8          # resident 256-thread blocks on the H100's SMs
MIN_ROWS = 4              # rows a thread sums at least in a slab
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Groups(NamedTuple):
    """A batch's contiguous groups on its device: the (n,) int32 group of
    each sample and the (g + 1,) int32 first sample of each group (and n
    at the end)."""
    seg: torch.Tensor
    off: torch.Tensor


class Plan(NamedTuple):
    """The reduction passes' geometry: tx threads along c (16 bytes each)
    and ty = THREADS // tx along the rows of a block, `tiles` channel
    tiles, `slabs` slabs of `rows` rows a sample."""
    tx: int
    ty: int
    tiles: int
    slabs: int
    rows: int


def vec(dtype):
    """Channels in one 16-byte load."""
    return 16 // dtype.itemsize


@functools.lru_cache(maxsize=None)
def plan(n, c, hw, dtype):
    """Tiles and slabs for n samples of c channels and hw rows: the slabs
    split each sample's rows until the blocks fill the card (BLOCKS),
    while each thread still sums MIN_ROWS rows or more."""
    cv = c // vec(dtype)
    tx = min(cv, 32)
    ty = THREADS // tx
    tiles = -(-cv // tx)
    want = -(-BLOCKS // (n * tiles))
    slabs = max(1, min(want, hw // (ty * MIN_ROWS)))
    rows = -(-hw // slabs)
    return Plan(tx, ty, tiles, -(-hw // rows), rows)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The launch functions of csrc/grouped_bn.cu, built at first use, and
    torch's raw current-stream and capture-state calls (a Stream object a
    call would cost more host time than a launch)."""
    from ust_run_tpu_torch.ops import cuda_build
    lib = cuda_build.load("grouped_bn")
    p, i = ctypes.c_void_p, ctypes.c_int
    sums = lib.gbn_sums_launch
    sums.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    apply_ = lib.gbn_apply_launch
    apply_.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
    grad = lib.gbn_input_grad_launch
    grad.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, p]
    for fn in (sums, apply_, grad):
        fn.restype = i
    return (sums, apply_, grad, torch._C._cuda_getCurrentRawStream,
            torch._C._cuda_isCurrentStreamCapturing)


def _on_card(x):
    """Whether x takes the kernels (CUDA) or the plain version (CPU); a
    CUDA tensor the kernels do not take raises. An empty one (a rank
    holding no sample of the batch) has nothing to launch."""
    if x.device.type == "cpu" or x.numel() == 0:
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim != 4 or x.dtype not in _DTYPES \
            or not x.is_contiguous(memory_format=torch.channels_last) \
            or x.shape[1] % vec(x.dtype) or x.data_ptr() % 16 \
            or not 0 < x.shape[0] <= 65535:
        raise ValueError(
            "grouped_bn takes a 4-D channels_last-contiguous bf16 or "
            "float32 CUDA tensor, 16-byte aligned, with channels a "
            f"multiple of {vec(x.dtype) if x.dtype in _DTYPES else 8}; got "
            f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")
    return True


def _launched(err, name, capturing):
    global launches, captured
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    if capturing():
        captured += 1
    else:
        launches += 1


def _same(x, *others):
    """Operands the kernels read beside x: its shape, type and layout."""
    for t in others:
        if t is not None and (
                t.shape != x.shape or t.dtype != x.dtype
                or t.device != x.device or t.data_ptr() % 16
                or not t.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype} "
                             f"{t.stride()} is not laid out as x "
                             f"{tuple(x.shape)} {x.dtype} {x.stride()}")


def _f32(t, shape):
    """A float32 coefficient table the kernels read as shaped."""
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"expected float32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _sums(mode, x, dy, y, groups, relu):
    n, c, h, w = x.shape
    p = plan(n, c, h * w, x.dtype)
    g = n if groups is None else groups.off.numel() - 1
    out = torch.empty((2, g, c), dtype=torch.float32, device=x.device)
    part = None
    if p.slabs > 1 or groups is not None:
        part = torch.empty((p.slabs, 2, n, c), dtype=torch.float32,
                           device=x.device)
    sums, _, _, stream, capturing = _kernels()
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = sums(mode, _DTYPES[x.dtype], x.data_ptr(), ptr(dy), ptr(y),
               ptr(part), out.data_ptr(),
               None if groups is None else groups.off.data_ptr(), g, n,
               h * w, c, p.tx, p.slabs, p.rows, int(relu),
               stream(x.device.index))
    _launched(err, "gbn_sums_launch", capturing)
    return out[0], out[1]


# ---------------------------------------------------------------- passes

def moments(x):
    """(s1, s2): the (n, c) float32 sums over h, w of x and of x^2."""
    if not _on_card(x):
        return moments_plain(x)
    return _sums(0, x, None, None, None, False)


def moments_plain(x):
    xf = x.float()
    return xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))


def apply(x, inv, shift, groups, relu):
    """y = x * inv[seg] - shift[seg] (inv, shift: (g, c) float32), then
    the ReLU if `relu`, in float32 rounded once to x's dtype."""
    if not _on_card(x):
        return apply_plain(x, inv, shift, groups, relu)
    n, c, h, w = x.shape
    g = groups.off.numel() - 1
    inv, shift = _f32(inv, (g, c)), _f32(shift, (g, c))
    y = torch.empty_like(x)
    _, launch, _, stream, capturing = _kernels()
    err = launch(_DTYPES[x.dtype], x.data_ptr(), y.data_ptr(),
                 inv.data_ptr(), shift.data_ptr(), groups.seg.data_ptr(), n,
                 h * w, c, int(relu), stream(x.device.index))
    _launched(err, "gbn_apply_launch", capturing)
    return y


def apply_plain(x, inv, shift, groups, relu):
    seg = groups.seg.long()
    z = x.float() * inv[seg][:, :, None, None] \
        - shift[seg][:, :, None, None]
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z.to(x.dtype)


def grad_sums(dy, y, x, groups, relu):
    """(a, b): the (g, c) float32 sums over each group's samples and h, w
    of dy' and dy' * x (dy' = dy where y > 0 if `relu`, else dy)."""
    if not _on_card(x):
        return grad_sums_plain(dy, y, x, groups, relu)
    _same(x, dy, y if relu else None)
    return _sums(1, x, dy, y if relu else None, groups, relu)


def _masked(dy, y, relu):
    g = dy.float()
    return g.masked_fill(y <= 0, 0.0) if relu else g


def grad_sums_plain(dy, y, x, groups, relu):
    g = _masked(dy, y, relu)
    per = torch.stack([g.sum(dim=(2, 3)), (g * x.float()).sum(dim=(2, 3))])
    out = per.new_zeros((2, groups.off.numel() - 1, x.shape[1]))
    out.index_add_(1, groups.seg.long(), per)
    return out[0], out[1]


def input_grad(dy, y, x, inv, groups, ds1, ds2, relu):
    """dx = dy' * inv[seg] + ds1 + 2 x ds2 (ds1, ds2: (n, c) float32), in
    float32 rounded once to x's dtype."""
    if not _on_card(x):
        return input_grad_plain(dy, y, x, inv, groups, ds1, ds2, relu)
    _same(x, dy, y if relu else None)
    n, c, h, w = x.shape
    inv = _f32(inv, (groups.off.numel() - 1, c))
    ds1, ds2 = _f32(ds1, (n, c)), _f32(ds2, (n, c))
    dx = torch.empty_like(x)
    _, _, launch, stream, capturing = _kernels()
    err = launch(_DTYPES[x.dtype], dy.data_ptr(),
                 y.data_ptr() if relu else None, x.data_ptr(), dx.data_ptr(),
                 inv.data_ptr(), groups.seg.data_ptr(), ds1.data_ptr(),
                 ds2.data_ptr(), n, h * w, c, int(relu),
                 stream(x.device.index))
    _launched(err, "gbn_input_grad_launch", capturing)
    return dx


def input_grad_plain(dy, y, x, inv, groups, ds1, ds2, relu):
    seg = groups.seg.long()
    dx = _masked(dy, y, relu) * inv[seg][:, :, None, None] \
        + ds1[:, :, None, None] + 2.0 * x.float() * ds2[:, :, None, None]
    return dx.to(x.dtype)


# -------------------------------------------------------------- Function

class _GroupedBN(torch.autograd.Function):
    """The train-mode forward and backward (module docstring). Saves x,
    and y when the ReLU's mask needs it: nothing in float32 at the
    activation's size."""

    @staticmethod
    def forward(ctx, x, weight, bias, coeffs, groups, relu):
        s1, s2 = moments(x)
        with torch.enable_grad():
            leaves = tuple(t.detach().requires_grad_()
                           for t in (s1, s2, weight, bias))
            inv, shift, mean, var = coeffs(*leaves)
        y = apply(x, inv.detach(), shift.detach(), groups, relu)
        ctx.save_for_backward(x, y if relu else None)
        ctx.graph = leaves, inv, shift
        ctx.groups, ctx.relu = groups, relu
        mean, var = mean.detach(), var.detach()
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, y = ctx.saved_tensors
        leaves, inv, shift = ctx.graph
        if dy.device.type == "cuda":
            # a gradient summed from several consumers may come strided
            dy = dy.contiguous(memory_format=torch.channels_last)
        a, b = grad_sums(dy, y, x, ctx.groups, ctx.relu)
        ds1, ds2, dw, db = torch.autograd.grad((inv, shift), leaves,
                                               (b, -a))
        dx = None
        if ctx.needs_input_grad[0]:
            dx = input_grad(dy, y, x, inv.detach(), ctx.groups, ds1, ds2,
                            ctx.relu)
        return (dx, dw if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None, None, None, None)


def grouped_bn(x, weight, bias, coeffs, groups, relu=False):
    """Train-mode GroupedBatchNorm of x (n, c, h, w) over `groups`, then
    the ReLU if `relu`: returns (y, mean, var), mean and var the (g, c)
    statistics `coeffs` gave (for the running statistics; no gradient).
    Without a gradient to take (the teacher under no_grad) nothing is
    saved and no graph is recorded."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupedBN.apply(x, weight, bias, coeffs, groups, relu)
    s1, s2 = moments(x)
    inv, shift, mean, var = coeffs(s1, s2, weight, bias)
    return apply(x, inv, shift, groups, relu), mean, var
