"""The port's UNet on a 2 x 2 mesh (4 Gloo ranks on the CPU: data 2 x
space 2) against the JAX UNet under `spatial_constraint` of
`make_mesh(4, spatial=2)` (the conftest's 8 CPU devices), float32, the
weights carried by ust_run_tpu_torch.convert.

One train-mode forward of 3 BN groups of 2 images (the teacher's call) at
48 x 48, so that each data index holds one image of each group and the
space axis cuts its 3 blocks of 16 rows as 2 + 1 (32 and 16 rows; at the
deepest level 2 rows and 1), and the backward of sum(logits * r). The
port gathers its logits over both axes and sums its gradients over the
ranks. Bars, those of tests/test_parallel.py:83-93: logits at rtol 1e-4,
atol 1e-5; the `outc` gradients at rtol 1e-3, with an absolute floor of
1e-5 of the tensor's largest entry (as tests/test_torch_unet_grads.py):
here the gradients reach ~300, sums of 13,824 products, and one entry of
-0.0585 differs from JAX's by 1.4e-3 of itself in the port without any
mesh too, so an absolute 1e-5 would test float32 summation order; and
the BN running statistics after the call at rtol/atol 1e-4
(torch_parity). The replicas are bit-equal.

The other parameters' gradients are not held to a bar. A ReLU input or a
max-pool pair within float32 rounding of a tie resolves differently when
the moments are summed over slabs instead of whole images, and moves
deep gradients by up to ~1e-2 of their norm (ROADMAP, Queue 3's caveat).
With the ReLUs swapped for tanh and the pools for average pools, the same
comparison against one process holds every gradient within 1e-5 of its
norm (`test_smooth_gradients_match_one_process`).

Planted controls, each of which must miss the logits' bar: the halo rows
zeroed (each slab padded as if it were the image's edge), and the BN
moments averaged over the rank's slab alone.
"""

import contextlib
import functools
import pathlib
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_dist as td
from torch_parity import np_tree, unet_pair
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.parallel.mesh import make_mesh, spatial_constraint
from ust_run_tpu_torch.convert import unet_state_dict_from_jax
from ust_run_tpu_torch.models import UNet
from ust_run_tpu_torch.parallel import bind_mesh

pytestmark = pytest.mark.usefixtures("single_thread")

S, GROUPS, SEED = 48, 3, 5


@contextlib.contextmanager
def planted(fault):
    """`fault` in place in this process for the block: "zero_halo",
    "local_bn", "smooth" (ReLU -> tanh, the ReLUs fused into the
    GroupedBatchNorms too; max-pool -> average pool) or None."""
    from torch import nn
    from ust_run_tpu_torch.models import layers
    from ust_run_tpu_torch.parallel import spatial
    gbn = layers.GroupedBatchNorm
    saved = [(spatial, "halo_rows", spatial.halo_rows),
             (layers, "slab_hw", layers.slab_hw),
             (nn.ReLU, "forward", nn.ReLU.forward),
             (nn.MaxPool2d, "forward", nn.MaxPool2d.forward),
             (gbn, "forward", gbn.forward)]
    if fault == "zero_halo":
        spatial.halo_rows = lambda x, mesh: F.pad(x, (0, 0, 1, 1))
    elif fault == "local_bn":
        layers.slab_hw = lambda sizes, h, w: h * w
    elif fault == "smooth":
        nn.ReLU.forward = lambda self, x: torch.tanh(x)
        gbn.forward = td.tanh_in_bn(gbn.forward)
        nn.MaxPool2d.forward = lambda self, x: F.avg_pool2d(x, 2)
    try:
        yield
    finally:
        for obj, name, v in saved:
            setattr(obj, name, v)


def run_unet(mesh, sd, x, r):
    """The port's UNet on this rank's share, or on the whole batch without
    a mesh: logits (gathered), gradients (summed over the ranks) and
    running statistics, and the replicas' largest difference."""
    net = UNet(x.shape[-1], r.shape[-1])
    net.load_state_dict(sd)
    sizes = (x.shape[0] // GROUPS,) * GROUPS
    kw = dict(groups=GROUPS)
    if mesh is not None:
        bind_mesh(net, mesh)
        x, kw["group_sizes"] = mesh.shard(x, sizes)
        r, _ = mesh.shard(r, sizes)
    y = net(x, **kw)
    (y * r).sum().backward()
    y = y.detach()
    out = dict(replica_diff=0.0)
    if mesh is not None:
        mesh.all_reduce_grads(net.parameters())
        y = mesh.gather(y, sizes, S)
        state = list(net.state_dict().values()) \
            + [p.grad for p in net.parameters()]
        out["replica_diff"] = mesh.max_replica_difference(state)
    out.update(logits=y, grads={n: p.grad for n, p in
                                net.named_parameters()},
               state={k: v for k, v in net.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))})
    return out


RUNS = (None, "zero_halo", "local_bn", "smooth")


def run_all(mesh, sd, x, r):
    """run_unet once for each of RUNS, in one spawn of the ranks; rank 0
    returns the results, the others their replica differences."""
    res = {}
    for fault in RUNS:
        with planted(fault):
            res[fault] = run_unet(mesh, sd, x, r)
        if mesh.rank:
            res[fault] = {"replica_diff": res[fault]["replica_diff"]}
    return res


@functools.lru_cache(maxsize=None)
def port_runs():
    """run_all on 4 ranks (data 2 x space 2), and one process's run with
    smooth kinks: ([rank results], one process's)."""
    *_, sd = jax_reference()
    x, r = (torch.from_numpy(a) for a in inputs())
    tmp = pathlib.Path(tempfile.mkdtemp())
    try:
        ranks = td.run_ranks(tmp, 4, run_all, sd, x, r, spatial=2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with td.one_thread(), planted("smooth"):
        one = run_unet(None, sd, x, r)
    return ranks, one


def inputs(channels=3, classes=2):
    rng = np.random.RandomState(SEED)
    x = rng.uniform(-1, 1, (2 * GROUPS, S, S, channels)).astype(np.float32)
    r = rng.normal(size=(2 * GROUPS, S, S, classes)).astype(np.float32)
    return x, r


@functools.lru_cache(maxsize=None)
def jax_reference():
    """(JAX logits, gradients, running statistics as a port state_dict,
    the port's state_dict of the initial weights)."""
    model, variables, _ = unet_pair(3, 2, 0, 0, S, seed=SEED)
    x, r = inputs()
    con = spatial_constraint(make_mesh(4, spatial=2))

    def loss(params):
        out, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            con(jnp.asarray(x)), train=True, groups=GROUPS,
            mutable=["batch_stats"])
        return jnp.sum(out * r), (out, upd["batch_stats"])

    (_, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    sd = unet_state_dict_from_jax(variables)
    g_sd = unet_state_dict_from_jax({"params": np_tree(grads),
                                     "batch_stats": variables["batch_stats"]})
    s_sd = unet_state_dict_from_jax({"params": variables["params"],
                                     "batch_stats": np_tree(stats)})
    return np.asarray(logits), g_sd, s_sd, sd


def test_unet_on_2x2_mesh_matches_jax_2d_mesh():
    logits_j, g_sd, s_sd, _ = jax_reference()
    ranks, _ = port_runs()
    assert [o[None]["replica_diff"] for o in ranks] == [0.0] * 4
    got = ranks[0][None]
    np.testing.assert_allclose(got["logits"].numpy(), logits_j, rtol=1e-4,
                               atol=1e-5)
    for name in ("outc.conv.weight", "outc.conv.bias"):
        want = g_sd[name].numpy()
        np.testing.assert_allclose(got["grads"][name].numpy(), want,
                                   rtol=1e-3, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    for name, v in got["state"].items():
        np.testing.assert_allclose(v.numpy(), s_sd[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("fault", ["zero_halo", "local_bn"])
def test_planted_faults_miss_the_bar(fault):
    logits_j, *_ = jax_reference()
    ranks, _ = port_runs()
    err = np.abs(ranks[0][fault]["logits"].numpy() - logits_j)
    assert not np.all(err <= 1e-5 + 1e-4 * np.abs(logits_j)), fault


def test_smooth_gradients_match_one_process():
    """With no kinks, every gradient of the 2 x 2 mesh is within 1e-5 of
    one process's, in norm (torch_dist.norm_errs)."""
    ranks, one = port_runs()
    got = ranks[0]["smooth"]
    assert [o["smooth"]["replica_diff"] for o in ranks] == [0.0] * 4
    torch.testing.assert_close(got["logits"], one["logits"], rtol=0,
                               atol=1e-5)
    errs = td.norm_errs(got["grads"], one["grads"])
    assert max(errs.values()) < 1e-5, max(errs.items(), key=lambda e: e[1])
