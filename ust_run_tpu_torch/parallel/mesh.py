"""The device mesh over processes (port of ust_run_tpu/parallel/mesh.py).

The JAX package lays its devices out as a 2-D `jax.sharding.Mesh` with
axes ("data", "space") and lets XLA insert the collectives. The port's
idiom is one process per rank, started by `torchrun` or spawned, with
`torch.distributed` (NCCL on the card, Gloo on the CPU). A `Mesh` is the
same 2-D layout over the process group: `init_distributed(...,
spatial=k)` puts rank r at data index r // k and space index r % k, as
`make_mesh(n, spatial=k)` reshapes its devices to (n // k, k)
(mesh.py:40-45); k must be a positive divisor of the world size.

The contract is the JAX mesh's: N ranks compute what one process computes
with the same global batch, within float summation order.
  * Replicated, identical on every rank: all state (both models, SGD
    momentum, queue, LQ carry, choice_th, the generators, the samplers)
    and every computation of the step outside the two model calls, so
    every rank draws the same random numbers whatever the mesh is.
  * Sharded: each rank takes a contiguous slice of every group of a model
    call over the data axis (`shard`; a slice may be empty) and, with a
    space axis, a contiguous run of image rows over it: whole blocks of
    ROW_BLOCK = 16 rows (the UNet's and Unet2D's total downsampling, 2^4;
    DeepLab's is 8), so that every level of every model holds whole rows
    on every rank, every slab starts on an even row at every stride-2
    layer, and pools of 2x2, transpose convs, 1x1 convolutions (strided
    ones too) and concatenations stay local. Each rank computes the loss
    terms of its (samples x rows) share.
  * Collectives, the only ones: GroupedBatchNorm's per-group moment sums
    (forward and backward; `shard` hands it the global group sizes and
    image height as `GroupSizes`), the halo rows of every operation whose
    window spans rows (parallel/spatial.py: convolutions of kernel > 1 at
    any stride and dilation, DeepLab's stem pool, bilinear resizes) over
    the space group, the loss terms' partial sums,
    the two logit gathers and the gradient all-reduce. Each is an
    `all_reduce` (sum or max) or a `broadcast`, the two collectives Gloo
    offers for CUDA tensors, so one code path runs under NCCL, under Gloo
    on the CPU and under Gloo on CUDA tensors; a gather (and a halo
    exchange) is the sum all-reduce of a zero buffer in which each rank
    fills its own rows.

Gradient convention. The loss is identical on every rank, and each rank's
backward produces only its own (samples x rows) share of the global
gradient; `all_reduce_grads` then sums the shares over the world. A sum
all-reduce inside the graph therefore has one of two backward rules, by
who consumes its result:
  * `sum_replicated`: the result feeds a computation every rank repeats
    (the loss from its partial sums). Every rank already holds the full
    gradient of the result, so the backward passes it through unchanged.
    An all-reduce here would count every share N times.
  * `sum_sharded`: the result feeds each rank's own share
    (GroupedBatchNorm's statistics). Each rank's upstream gradient is only
    its share's, so the backward sums it over the ranks (the
    SyncBatchNorm pattern).
`all_reduce_grads` sums; `DistributedDataParallel` would average, and is
not used.

Differences from GSPMD, deliberate: an image whose height is not a
multiple of ROW_BLOCK, or has fewer blocks than the space axis has ranks
(patch 32 over space 4), raises a ValueError where GSPMD pads; and only
the models whose every operation has a slab version run on a space axis
(`bind_mesh`: the UNet, Unet2D with BatchNorm, DeepLabV2 and its ResNet;
it raises for the rest).
"""

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _unflatten_dense_tensors


def shard_slice(n, rank, world):
    """This rank's contiguous share of n rows: the first n % world ranks
    take one row more, and a share may be empty."""
    base, extra = divmod(n, world)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (rank < extra))


ROW_BLOCK = 16


def wire_dtype(dtype):
    """The dtype a tensor travels in through a sum all-reduce: float32 for
    16-bit floats (which it holds exactly, and which every backend sums),
    else its own."""
    return torch.float32 if dtype in (torch.float16, torch.bfloat16) \
        else dtype


def check_spatial(spatial, world):
    """make_mesh's validation of the space axis (mesh.py:35-39)."""
    if spatial <= 0 or world % spatial != 0:
        raise ValueError(
            f"spatial axis size {spatial} must be a positive divisor of "
            f"the mesh size {world}")


def check_num_devices(num_devices, world):
    """`--num_devices` against the ranks (make_mesh's validation,
    mesh.py:30-39): it names the mesh size, and the port's mesh is the
    process group, so any other size raises."""
    if num_devices is None:
        return
    if num_devices <= 0:
        raise ValueError(f"num_devices must be positive, got {num_devices}")
    if num_devices != world:
        raise ValueError(
            f"requested a {num_devices}-device mesh but the run has {world} "
            f"rank(s). Launch with `torchrun --nproc_per_node "
            f"{num_devices}` or drop --num_devices.")


class GroupSizes(tuple):
    """A rank's local group sizes (the tuple itself) and, as `total`, the
    global batch's group sizes they were cut from: what a sharded
    GroupedBatchNorm divides its summed moments by. On a space axis,
    `height` and `width` are the model input's global height and width
    (None without one): the rows are a slab of the image, and a layer at
    width w spans height * w // width rows in all."""

    def __new__(cls, local, total, height=None, width=None):
        self = super().__new__(cls, local)
        self.total = tuple(total)
        self.height, self.width = height, width
        return self


class _SumAllReduce(torch.autograd.Function):
    """Sum over the ranks, in place on `x` (a fresh sum or concatenation,
    whose own backward needs no value of it); the backward rule of the
    module docstring."""

    @staticmethod
    def forward(ctx, x, group, sharded):
        ctx.group, ctx.sharded = group, sharded
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        if ctx.sharded:
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


@dataclasses.dataclass
class Mesh:
    """The 2-D mesh: `world` ranks as (world // space) x `space`, this one
    `rank`; collectives over the world `group` and over this rank's
    `space_group` (the ranks of its data index), on tensors of
    `device`."""
    rank: int
    world: int
    device: torch.device
    group: Any = None
    space: int = 1
    space_group: Any = None

    def __post_init__(self):
        check_spatial(self.space, self.world)

    @property
    def data(self):
        return self.world // self.space

    @property
    def data_index(self):
        return self.rank // self.space

    @property
    def space_index(self):
        return self.rank % self.space

    # ------ layout ---------------------------------------------------
    def row_slice(self, height, space_index=None):
        """This rank's rows of an image `height` rows high (or those of
        the rank at `space_index` of its space group): whole blocks of
        ROW_BLOCK rows, cut over the space axis as `shard_slice` cuts
        samples (288 rows over 4 ranks: 5, 5, 4, 4 blocks)."""
        if space_index is None:
            space_index = self.space_index
        if self.space == 1:
            return slice(0, height)
        blocks, rest = divmod(height, ROW_BLOCK)
        if rest or blocks < self.space:
            raise ValueError(
                f"a space axis of {self.space} ranks needs an image height "
                f"that is a multiple of {ROW_BLOCK} rows with at least one "
                f"block of {ROW_BLOCK} per rank; got {height} rows")
        sl = shard_slice(blocks, space_index, self.space)
        return slice(sl.start * ROW_BLOCK, sl.stop * ROW_BLOCK)

    def shard(self, x, sizes):
        """x: NHWC rows made of groups of `sizes` rows -> (this rank's
        rows: a contiguous slice of each group over the data axis and,
        with a space axis, its image rows; the local group sizes as
        GroupSizes)."""
        parts, local, start = [], [], 0
        for n in sizes:
            sl = shard_slice(n, self.data_index, self.data)
            parts.append(x[start + sl.start:start + sl.stop])
            local.append(sl.stop - sl.start)
            start += n
        rows = parts[0] if len(parts) == 1 else torch.cat(parts)
        if self.space == 1:
            return rows, GroupSizes(local, sizes)
        return (rows[:, self.row_slice(x.shape[1])].contiguous(),
                GroupSizes(local, sizes, x.shape[1], x.shape[2]))

    def gather(self, local, sizes, height=None):
        """The inverse of `shard`: every group's rows on every rank, bit
        for bit (a sum all-reduce of a zero buffer holding one rank's
        share at each position); `height` is the image's global height,
        which a space axis needs. Not differentiable. 16-bit floats travel
        as float32 (`wire_dtype`)."""
        dtype = wire_dtype(local.dtype)
        shape, rows = tuple(local.shape[1:]), ()
        if self.space > 1:
            if height is None:
                raise ValueError("gather over a space axis needs the "
                                 "image's global height")
            shape, rows = (height,) + shape[1:], (self.row_slice(height),)
        out = local.new_zeros((sum(sizes),) + shape, dtype=dtype)
        start = pos = 0
        for n in sizes:
            sl = shard_slice(n, self.data_index, self.data)
            k = sl.stop - sl.start
            out[(slice(start + sl.start, start + sl.stop),) + rows] = \
                local[pos:pos + k]
            start += n
            pos += k
        dist.all_reduce(out, group=self.group)
        return out.to(local.dtype)

    # ------ collectives ----------------------------------------------
    def sum_replicated(self, x):
        """Sum over the ranks for a replicated consumer (the loss from its
        partial sums): backward passes the gradient through."""
        return _SumAllReduce.apply(x, self.group, False)

    def sum_sharded(self, x):
        """Sum over the ranks for sharded consumers (BN statistics):
        backward sums the gradient over the ranks."""
        return _SumAllReduce.apply(x, self.group, True)

    def all_reduce_grads(self, params):
        """Sum every parameter's gradient over the ranks, in one flat
        all-reduce. A parameter without a gradient (the same ones on every
        rank, which all run the same graph) contributes zeros and keeps
        None."""
        params = list(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        kept = [i for i, p in enumerate(params) if p.grad is not None]
        summed = _unflatten_dense_tensors(flat, grads)
        torch._foreach_copy_([grads[i] for i in kept],
                             [summed[i] for i in kept])

    def sum_numpy(self, a):
        """A float64 numpy array summed over the ranks (a host sync)."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.float64)) \
            .to(self.device)
        dist.all_reduce(t, group=self.group)
        return t.cpu().numpy()

    def any(self, flag):
        """True on every rank when `flag` is true on any rank."""
        t = torch.tensor(int(bool(flag)), device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def max_replica_difference(self, tensors):
        """max |t - t on rank 0| over `tensors` and their elements, the
        same on every rank: 0 when the replicas hold equal values. Tensors
        are compared by dtype, each dtype in one flat broadcast."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t.detach().reshape(-1))
        worst = torch.zeros((), dtype=torch.float64, device=self.device)
        for ts in by_dtype.values():
            mine = torch.cat(ts).to(self.device)
            ref = mine.clone()
            dist.broadcast(ref, 0, group=self.group)
            if mine.numel():
                worst = torch.maximum(
                    worst, (mine.double() - ref.double()).abs().max())
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=self.group)
        return worst.item()

    def close(self):
        dist.destroy_process_group()


DataMesh = Mesh     # the name of the data-only mesh before the space axis


def bind_mesh(model, mesh):
    """Bind `mesh` to every GroupedBatchNorm of `model` (in train mode its
    statistics become those of the global batch) and to every slab-aware
    module (parallel.spatial.SlabAware: on a row slab their convolutions,
    pools and resizes of kernel > 1 take halo rows). On a space axis only
    the UNet, Unet2D with BatchNorm and DeepLabV2 (or its ResNet) run:
    any other model raises, naming it, since a layer without a slab
    version would zero-pad every slab's edges, or normalise a sample over
    its slab alone (GroupNorm, InstanceNorm, DSBN)."""
    from torch import nn
    from ust_run_tpu_torch.models import (DeepLabV2,
                                          DomainSpecificBatchNorm2d,
                                          GroupedBatchNorm, ResNet, UNet,
                                          Unet2D)
    from ust_run_tpu_torch.parallel.spatial import SlabAware
    if mesh.space > 1:
        per_sample = (nn.GroupNorm, nn.InstanceNorm2d,
                      DomainSpecificBatchNorm2d)
        if not isinstance(model, (UNet, Unet2D, DeepLabV2, ResNet,
                                  GroupedBatchNorm)) \
                or any(isinstance(m, per_sample) for m in model.modules()):
            raise ValueError(
                f"the space axis shards the UNet, Unet2D with BatchNorm and "
                f"DeepLabV2; {type(model).__name__} cannot run on a mesh "
                f"with {mesh.space} space ranks")
    for mod in model.modules():
        if isinstance(mod, (GroupedBatchNorm, SlabAware)):
            mod.mesh = mesh
    return model


sync_batchnorm = bind_mesh


def init_distributed(backend=None, device="cuda", init_method="env://",
                     rank=None, world_size=None, spatial=1) -> Optional[Mesh]:
    """Start the process group (counterpart of cli.maybe_init_distributed)
    and lay the ranks out as a (world // spatial) x spatial mesh.

    With `rank` and `world_size` None, reads torchrun's RANK, WORLD_SIZE
    and LOCAL_RANK (and, for the default `env://`, MASTER_ADDR and
    MASTER_PORT) and returns None unless WORLD_SIZE > 1: a plain launch
    runs the single-process path. The rank's device is `device`, with a
    bare "cuda" taken as cuda:LOCAL_RANK (cuda:rank when `rank` and
    `world_size` are given). The backend is NCCL for a CUDA device and
    Gloo for the CPU unless `backend` names one. `spatial` must be a
    positive divisor of the world size (ValueError, as make_mesh); with
    spatial > 1 every rank creates every space group, in order. A failure
    raises; nothing carries on without the group."""
    if rank is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        check_spatial(spatial, world_size)
        if world_size <= 1:
            return None
        rank = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
        check_spatial(spatial, world_size)
        local_rank = rank
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    space_group = None
    if spatial == world_size:
        space_group = dist.group.WORLD
    elif spatial > 1:
        for d in range(world_size // spatial):
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if d == rank // spatial:
                space_group = g
    return Mesh(rank=rank, world=world_size, device=dev,
                group=dist.group.WORLD, space=spatial,
                space_group=space_group)
