"""The space axis's halo exchange and the 3x3 convolution on a row slab.

On a mesh with a space axis (parallel/mesh.py) each rank holds a
contiguous run of every image's rows. A 3x3 convolution with zero padding
1 then needs one row from each neighbouring slab: `halo_rows` adds them
(zeros at the image's top and bottom edges, which is the convolution's
own zero padding) and `conv3x3` convolves the haloed slab with padding 1
in width only. The JAX package leaves this to GSPMD's spatial partitioner
(ust_run_tpu/parallel/mesh.py:11-13).

Transport is one sum all-reduce over the space group of a zero buffer
(space, 2, N, C, W) in which each rank fills its own first and last row,
forward, and the gradients of its halo rows in its neighbours' places,
backward: the one code path that Gloo on CUDA tensors, Gloo on the CPU and
NCCL all take (Gloo offers only `all_reduce` and `broadcast` for CUDA
tensors). Each position has one non-zero contributor, so the sum is a
copy. 16-bit values travel as float32, which holds them exactly.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ust_run_tpu_torch.parallel.mesh import wire_dtype


class _HaloRows(torch.autograd.Function):
    """(N, C, h, W) -> (N, C, h + 2, W): the rank's slab between the last
    row of the slab above and the first row of the slab below. Backward
    returns each halo row's gradient to the rank that owns the row, which
    adds it to its edge row."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n, c, h, w = x.shape
        s, k = mesh.space_index, mesh.space
        buf = x.new_zeros((k, 2, n, c, w), dtype=wire_dtype(x.dtype))
        buf[s, 0] = x[:, :, 0]
        buf[s, 1] = x[:, :, h - 1]
        dist.all_reduce(buf, group=mesh.space_group)
        # the model's layout: NCHW-shaped, channels_last in memory
        fmt = torch.channels_last if x.stride(1) == 1 and c > 1 \
            else torch.contiguous_format
        out = torch.empty((n, c, h + 2, w), dtype=x.dtype, device=x.device,
                          memory_format=fmt)
        out[:, :, 1:h + 1] = x
        out[:, :, 0] = buf[s - 1, 1] if s > 0 else 0
        out[:, :, h + 1] = buf[s + 1, 0] if s < k - 1 else 0
        return out

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        n, c, h2, w = grad.shape
        h = h2 - 2
        s, k = mesh.space_index, mesh.space
        buf = grad.new_zeros((k, 2, n, c, w), dtype=wire_dtype(grad.dtype))
        if s > 0:
            buf[s - 1, 1] = grad[:, :, 0]
        if s < k - 1:
            buf[s + 1, 0] = grad[:, :, h + 1]
        dist.all_reduce(buf, group=mesh.space_group)
        gx = grad[:, :, 1:h + 1].clone()
        gx[:, :, 0] += buf[s, 0].to(gx.dtype)
        gx[:, :, h - 1] += buf[s, 1].to(gx.dtype)
        return gx, None


def halo_rows(x, mesh):
    """x (N, C, h, W), this rank's rows -> (N, C, h + 2, W) with the
    neighbours' edge rows (zeros at the image's edges); differentiable."""
    return _HaloRows.apply(x, mesh)


def conv3x3(x, weight, mesh):
    """`F.conv2d(x, weight, padding=1)` of the whole image, restricted to
    this rank's rows: the haloed slab convolved with padding (0, 1)."""
    return F.conv2d(halo_rows(x, mesh), weight, padding=(0, 1))
