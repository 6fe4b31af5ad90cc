"""Data parallelism over processes (port of ust_run_tpu/parallel/mesh.py).

The JAX package shards each batch over the "data" axis of a
`jax.sharding.Mesh` and lets XLA insert the collectives. The port's idiom
is one process per GPU, started by `torchrun`, with `torch.distributed`
(NCCL on the card, Gloo on the CPU). A `DataMesh` is that axis: this
process's rank, the world size, the process group and the rank's device.

The contract is the JAX mesh's: N ranks compute what one process computes
with the same global batch, within float summation order.
  * Replicated, identical on every rank: all state (both models, SGD
    momentum, queue, LQ carry, choice_th, the generators, the samplers)
    and every computation of the step outside the two model calls, so
    every rank draws the same random numbers whatever N is.
  * Sharded: each rank takes a contiguous slice of every group of a model
    call (`shard`; a slice may be empty) and the loss terms of its slice.
  * Collectives, the only ones: GroupedBatchNorm's per-group moment sums
    (forward and backward; `shard` hands it the global group sizes as
    `GroupSizes`), the loss terms' partial sums, the two
    logit gathers and the gradient all-reduce. Each is an `all_reduce`
    (sum or max) or a `broadcast`, the two collectives Gloo offers for
    CUDA tensors, so one code path runs under NCCL, under Gloo on the CPU
    and under Gloo on CUDA tensors; a gather is the sum all-reduce of a
    zero buffer in which each rank fills its own rows.

Gradient convention. The loss is identical on every rank, and each rank's
backward produces only its own samples' share of the global gradient;
`all_reduce_grads` then sums the shares. A sum all-reduce inside the graph
therefore has one of two backward rules, by who consumes its result:
  * `sum_replicated`: the result feeds a computation every rank repeats
    (the loss from its partial sums). Every rank already holds the full
    gradient of the result, so the backward passes it through unchanged.
    An all-reduce here would count every share N times.
  * `sum_sharded`: the result feeds each rank's own samples
    (GroupedBatchNorm's statistics). Each rank's upstream gradient is only
    its samples' share, so the backward sums it over the ranks (the
    SyncBatchNorm pattern).
`all_reduce_grads` sums; `DistributedDataParallel` would average, and is
not used.

The mesh's "space" axis (spatial model parallelism) is not ported.
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
    GroupedBatchNorm divides its summed moments by."""

    def __new__(cls, local, total):
        self = super().__new__(cls, local)
        self.total = tuple(total)
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
class DataMesh:
    """The data axis: `world` ranks, this one `rank`, collectives over
    `group` on tensors of `device`."""
    rank: int
    world: int
    device: torch.device
    group: Any = None

    # ------ layout ---------------------------------------------------
    def shard(self, x, sizes):
        """x: rows made of groups of `sizes` rows -> (this rank's rows: a
        contiguous slice of each group, the local group sizes as
        GroupSizes)."""
        parts, local, start = [], [], 0
        for n in sizes:
            sl = shard_slice(n, self.rank, self.world)
            parts.append(x[start + sl.start:start + sl.stop])
            local.append(sl.stop - sl.start)
            start += n
        rows = parts[0] if len(parts) == 1 else torch.cat(parts)
        return rows, GroupSizes(local, sizes)

    def gather(self, local, sizes):
        """The inverse of `shard`: every group's rows on every rank, bit
        for bit (a sum all-reduce of a zero buffer holding one rank's
        rows at each position). Not differentiable. 16-bit floats travel
        as float32, which holds them exactly and which every backend
        sums."""
        dtype = torch.float32 if local.dtype in (torch.float16,
                                                 torch.bfloat16) \
            else local.dtype
        out = local.new_zeros((sum(sizes),) + tuple(local.shape[1:]),
                              dtype=dtype)
        start = pos = 0
        for n in sizes:
            sl = shard_slice(n, self.rank, self.world)
            k = sl.stop - sl.start
            out[start + sl.start:start + sl.stop] = local[pos:pos + k]
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


def sync_batchnorm(model, mesh):
    """Point every GroupedBatchNorm of `model` at `mesh`: in train mode its
    statistics become means over the global batch."""
    from ust_run_tpu_torch.models.layers import GroupedBatchNorm
    for mod in model.modules():
        if isinstance(mod, GroupedBatchNorm):
            mod.mesh = mesh
    return model


def init_distributed(backend=None, device="cuda", init_method="env://",
                     rank=None, world_size=None) -> Optional[DataMesh]:
    """Start the process group (counterpart of cli.maybe_init_distributed).

    With `rank` and `world_size` None, reads torchrun's RANK, WORLD_SIZE
    and LOCAL_RANK (and, for the default `env://`, MASTER_ADDR and
    MASTER_PORT) and returns None unless WORLD_SIZE > 1: a plain launch
    runs the single-process path. The rank's device is `device`, with a
    bare "cuda" taken as cuda:LOCAL_RANK (cuda:rank when `rank` and
    `world_size` are given). The backend is NCCL for a CUDA device and
    Gloo for the CPU unless `backend` names one. A failure raises; nothing
    carries on without the group."""
    if rank is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        if world_size <= 1:
            return None
        rank = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
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
    return DataMesh(rank=rank, world=world_size, device=dev,
                    group=dist.group.WORLD)
