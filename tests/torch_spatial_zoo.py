"""Shared helpers of the zoo's space-axis tests (tests/test_torch_spatial_
{deeplab,deeplab4,unet2d}.py): the JAX model's train-mode call on a 2-D
mesh and its gradients, the port's on Gloo ranks (tests/torch_dist.py),
the bars, and the seed scan that found their seeds:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=tests:. python tests/torch_spatial_zoo.py KIND SIZE \\
        WORLD SPATIAL [SEEDS]

prints, per seed, the largest logit difference and the worst gradient's
distance (in norm) from JAX of the port on the mesh, as is and with
smooth kinks (every ReLU a tanh in both packages); `... torch_spatial_
zoo.py jax-step MODEL SEED` (MODEL unet or unet2d) prints how far the
JAX step on each mesh lies from its own unsharded step.

A ReLU input within float32 rounding of 0 resolves differently when the
BN moments are slab sums rather than whole-image means, and moves deep
gradients by 1e-3 to 4e-2 in norm (ROADMAP, Queue 3's caveat). With
tanh in its place there is no kink to flip, so the gradients of every
seed can be held to a tight bar.
"""

import contextlib
import functools
import pathlib
import shutil
import sys
import tempfile

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_dist as td
from torch_parity import init_fn, np_tree, random_variables
from ust_run_tpu.models import DeepLabV2 as JaxDeepLab
from ust_run_tpu.models import Unet2D as JaxUnet2D
from ust_run_tpu.models.resnet import ResNet as JaxResNet
from ust_run_tpu.parallel.mesh import make_mesh, spatial_constraint
from ust_run_tpu_torch import convert

GROUPS = 3
CONVERT = {"resnet": convert.resnet_state_dict_from_jax,
           "r50": convert.deeplab_state_dict_from_jax,
           "unet2d": convert.unet2d_state_dict_from_jax}


def jax_model(kind):
    return {"resnet": lambda: JaxResNet(layers=(1, 1, 1, 1)),
            "r50": lambda: JaxDeepLab(backbone="resnet50", nclass=2),
            "unet2d": lambda: JaxUnet2D(c=3, num_classes=2)}[kind]()


@contextlib.contextmanager
def smooth_jax(smooth):
    """Every flax ReLU a tanh while a call is traced, when `smooth`."""
    relu = flax.linen.relu
    if smooth:
        flax.linen.relu = jnp.tanh
    try:
        yield
    finally:
        flax.linen.relu = relu


@functools.lru_cache(maxsize=None)
def jax_step(kind, world, spatial, smooth):
    """The jitted train-mode call of 3 BN groups and the gradient of
    sum(y * r), on `make_mesh(world, spatial=spatial)`."""
    model = jax_model(kind)
    con = spatial_constraint(make_mesh(world, spatial=spatial))

    def loss(params, stats, x, r):
        with smooth_jax(smooth):
            out, upd = model.apply(
                {"params": params, "batch_stats": stats}, con(x),
                train=True, groups=GROUPS, mutable=["batch_stats"])
        if kind == "resnet":
            out = out[-1]
        return jnp.sum(out * r), (out, upd["batch_stats"])

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@functools.lru_cache(maxsize=None)
def jax_reference(kind, seed, size, world, spatial, smooth=False):
    """(x, r (the port's layout), the port's initial state_dict, JAX's y,
    gradients and running statistics as port state_dicts): 2 images of
    each of the 3 groups, drawn with numpy from `seed`."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (2 * GROUPS, size, size, 3)).astype(np.float32)
    model = jax_model(kind)
    v = random_variables(init_fn(model, x[:1], train=False), seed + 10)
    shape = (2 * GROUPS, size // 8, size // 8, 2048) if kind == "resnet" \
        else (2 * GROUPS, size, size, 2)
    r = rng.normal(size=shape).astype(np.float32)
    (_, (y, stats)), grads = jax_step(kind, world, spatial, smooth)(
        v["params"], v["batch_stats"], x, r)
    to_sd = CONVERT[kind]
    y = np.asarray(y)
    if kind == "resnet":            # the port's c4 and r are NCHW
        y, r = y.transpose(0, 3, 1, 2), r.transpose(0, 3, 1, 2)
    return (x, r, to_sd(v), y,
            to_sd({"params": np_tree(grads),
                   "batch_stats": v["batch_stats"]}),
            to_sd({"params": v["params"], "batch_stats": np_tree(stats)}))


def port_runs(runs, world, spatial):
    """td.run_zoo_models on `world` ranks laid out as (world // spatial)
    x spatial, in one spawn; `runs` of (kind, seed, size, fault), where
    fault "smooth" holds the JAX reference's tanh too. Rank 0's results
    by run; the replicas must be bit-equal."""
    tmp = pathlib.Path(tempfile.mkdtemp())
    args = []
    for kind, seed, size, fault in runs:
        x, r, sd, *_ = jax_reference(kind, seed, size, world, spatial,
                                     fault == "smooth")
        args.append((kind, sd, torch.from_numpy(x), torch.from_numpy(r),
                     GROUPS, fault))
    try:
        res = td.run_ranks(tmp, world, td.run_zoo_models, args,
                           spatial=spatial)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert [o["replica_diff"] for rank in res for o in rank] \
        == [0.0] * (world * len(runs))
    return dict(zip(runs, res[0]))


def y_bars(kind):
    """tests/test_torch_zoo.py's bars: ResNet's c4 and Unet2D's logits at
    rtol/atol 1e-4, DeepLab's logits at rtol 1e-4 and atol 6e-4."""
    return dict(rtol=1e-4, atol=6e-4 if kind == "r50" else 1e-4)


def grad_errors(got, want):
    """({parameter: ||got - want|| / ||want||}, the largest |got| over
    1e-5 of the largest entry of any JAX gradient, among the gradients
    that are zero but for rounding: those of a conv bias that a BatchNorm
    follows, Unet2D's, whose entries stay below that)."""
    top = max(float(np.abs(v.numpy()).max()) for v in want.values())
    errs, zero = {}, 0.0
    for k, g in got.items():
        w = want[k].numpy()
        if np.abs(w).max() < 1e-5 * top:
            zero = max(zero, float(np.abs(g.numpy()).max()) / (1e-5 * top))
        else:
            errs[k] = float(np.linalg.norm(g.numpy() - w)
                            / np.linalg.norm(w))
    return errs, zero


def check_against_jax(got, kind, seed, size, world, spatial,
                      grad_rtol=None, smooth=False):
    """y, the running statistics (rtol/atol 1e-4) and, given `grad_rtol`,
    every gradient (in norm) of a port run against the JAX reference."""
    *_, y_j, g_sd, s_sd = jax_reference(kind, seed, size, world, spatial,
                                        smooth)
    np.testing.assert_allclose(got["y"].numpy(), y_j, **y_bars(kind))
    for name, v in got["state"].items():
        np.testing.assert_allclose(v.numpy(), s_sd[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    if grad_rtol is not None:
        errs, zero = grad_errors(got["grads"], g_sd)
        worst = max(errs.items(), key=lambda e: e[1])
        assert worst[1] < grad_rtol and zero < 1.0, (worst, zero)


def misses_y_bar(got, kind, seed, size, world, spatial):
    y_j = jax_reference(kind, seed, size, world, spatial)[3]
    return not np.allclose(got["y"].numpy(), y_j, **y_bars(kind))


def jax_step_departure(model, seed):
    """The JAX step's (`make_step_parts`, tests/test_torch_step.py's
    setup) loss and worst gradient (in norm; gradients zero but for
    rounding left out) on each mesh against its own unsharded step."""
    from test_torch_step import _corpus, _hp, _jax_state, _Recorder
    from ust_run_tpu.models import UNet as JaxUNet
    from ust_run_tpu.semisup.step import make_step_parts
    hp = _hp("fundus")

    def run(mesh):
        r = np.random.RandomState(seed)
        net = JaxUNet(n_channels=3, n_classes=2) if model == "unet" \
            else JaxUnet2D(c=3, num_classes=2)
        _, build_inputs, loss_terms = make_step_parts(_Recorder(net), hp,
                                                      mesh)
        data = _corpus(hp, r)
        idx = {"lb_idx": np.asarray([0, 3], np.int32),
               "ulb_idx": np.asarray([1, 4], np.int32)}
        js = _jax_state(hp, net, r, 0, 0.1, seed * 10)
        inp = jax.jit(build_inputs)(js, data, idx)
        (loss, _), g = jax.jit(jax.value_and_grad(loss_terms, has_aux=True))(
            js.params, js, inp)
        return float(loss), jax.tree_util.tree_leaves_with_path(np_tree(g))

    loss0, g0 = run(None)
    top = max(float(np.abs(v).max()) for _, v in g0)
    for shape in ((2, 1), (4, 1), (2, 2), (4, 2), (4, 4)):
        loss, g = run(make_mesh(shape[0], spatial=shape[1]))
        worst = max((float(np.linalg.norm(a - b) / np.linalg.norm(b)),
                     jax.tree_util.keystr(p)) for (p, a), (_, b) in zip(g, g0)
                    if np.abs(b).max() >= 1e-5 * top)
        print(model, seed, "make_mesh", shape, "loss", loss, "unsharded",
              loss0, "worst gradient", worst, flush=True)


if __name__ == "__main__" and sys.argv[1] == "jax-step":
    # the JAX step's departure on make_mesh(4, spatial=2) (ROADMAP Queue 3):
    #   ... python tests/torch_spatial_zoo.py jax-step unet2d 2
    jax_step_departure(sys.argv[2], int(sys.argv[3]))
elif __name__ == "__main__":
    kind, size, world, spatial = sys.argv[1], *map(int, sys.argv[2:5])
    for seed in range(int(sys.argv[5]) if len(sys.argv) > 5 else 12):
        runs = [(kind, seed, size, None), (kind, seed, size, "smooth")]
        res = port_runs(runs, world, spatial)
        for run in runs:
            *_, y_j, g_sd, _ = jax_reference(kind, seed, size, world,
                                             spatial, run[3] == "smooth")
            errs, zero = grad_errors(res[run]["grads"], g_sd)
            print(seed, run[3] or "relu", "y",
                  float(np.abs(res[run]["y"].numpy() - y_j).max()),
                  "worst gradient", max(errs.items(), key=lambda e: e[1]),
                  "zero ones", zero, flush=True)
