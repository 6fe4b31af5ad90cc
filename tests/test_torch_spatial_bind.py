"""Which models run on a space axis, and that a bound model never runs an
operation of kernel > 1 on a slab outside parallel/spatial.py (on Gloo
ranks on the CPU, tests/torch_dist.py).

  * `bind_mesh` on a 1 x 2 mesh binds the UNet, Unet2D with BatchNorm,
    DeepLabV2 (ResNet-50 and -101) and its ResNet: every GroupedBatchNorm
    and every slab-aware module gets the mesh. It raises, naming the
    model, for Unet2D with DSBN (`--model unet2d_dsbn`), with GroupNorm
    or InstanceNorm (per-sample statistics a slab cannot give), Unet2D_MT
    and WideResNet. The trainer builds the zoo on a space axis.
  * No silent fallback: with F.conv2d, F.max_pool2d and F.interpolate
    watched and a forward pre-hook on every nn.Conv2d of kernel > 1, one
    train-mode call of each bound model on a slab (1 x 2, 32 px) makes
    no call that spans rows (a convolution of kernel height > 1, a pool
    whose windows overlap or pad, any resize) from anywhere but
    parallel/spatial.py. The 2x2 pools and the 1x1 convolutions are
    local and may run anywhere. The watch sees a planted fallback (the
    module's own forward instead of spatial.conv), and a slab-aware
    module called on a slab without a mesh bound raises.
"""

import sys

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import torch_dist as td
from ust_run_tpu_torch.models import (DeepLabV2, ResNet, UNet, Unet2D,
                                      Unet2D_MT, build_WideResNet)
from ust_run_tpu_torch.parallel import GroupSizes, bind_mesh, spatial
from ust_run_tpu_torch.parallel.mesh import Mesh
from ust_run_tpu_torch.parallel.spatial import SlabAware

S = 32
MODELS = {"unet": lambda: UNet(3, 2),
          "unet2d": lambda: Unet2D(c=3, num_classes=2),
          "deeplabv2_r50": lambda: DeepLabV2("resnet50", 2),
          "resnet": lambda: ResNet((1, 1, 1, 1))}


def _mesh():
    return Mesh(rank=0, world=2, device=torch.device("cpu"), space=2)


@pytest.mark.parametrize("name", ["unet", "unet2d", "deeplabv2_r50",
                                  "deeplabv2", "resnet"])
def test_bind_mesh_binds_the_models_of_the_space_axis(name):
    net = DeepLabV2("resnet101", 2) if name == "deeplabv2" \
        else MODELS[name]()
    mesh = _mesh()
    assert bind_mesh(net, mesh) is net
    aware = [m for m in net.modules() if isinstance(m, SlabAware)]
    assert aware and all(m.mesh is mesh for m in aware)


@pytest.mark.parametrize("name,make", [
    ("Unet2D", lambda: Unet2D(c=1, norm="dsbn", num_domains=2)),
    ("Unet2D", lambda: Unet2D(c=1, norm="gn")),
    ("Unet2D", lambda: Unet2D(c=1, norm="in")),
    ("Unet2D_MT", lambda: Unet2D_MT(c=1)),
    ("WideResNet", lambda: build_WideResNet(depth=10).build(
        num_classes=5, in_channel=3))])
def test_bind_mesh_raises_for_the_other_models(name, make):
    with pytest.raises(ValueError, match=f"; {name} cannot run on a mesh "
                                         f"with 2 space ranks"):
        bind_mesh(make(), _mesh())


def _spans_rows(name, args, kw):
    if name == "conv2d":
        weight = args[1] if len(args) > 1 else kw["weight"]
        return weight.shape[2] > 1
    if name == "max_pool2d":
        k = args[1] if len(args) > 1 else kw["kernel_size"]
        s = args[2] if len(args) > 2 else kw.get("stride") or k
        p = args[3] if len(args) > 3 else kw.get("padding", 0)
        first = (lambda v: v[0] if isinstance(v, (tuple, list)) else v)
        return first(k) > first(s) or first(p) > 0
    return True                                     # interpolate


def run_walks(mesh):
    """run_walk without and with the planted fallback."""
    return [run_walk(mesh, fallback) for fallback in (False, True)]


def run_walk(mesh, fallback):
    """One train-mode call of each of MODELS on this rank's slab, the row-
    spanning calls from outside parallel/spatial.py listed; with
    `fallback`, spatial.conv runs the module's own forward."""
    seen = {}
    watched = {n: getattr(F, n) for n in ("conv2d", "max_pool2d",
                                          "interpolate")}

    def watch(name, fn):
        def wrapped(*args, **kw):
            caller = sys._getframe(1).f_globals.get("__name__")
            if caller != spatial.__name__ and _spans_rows(name, args, kw):
                seen[model].append(f"{name} from {caller}")
            return fn(*args, **kw)
        return wrapped

    conv = spatial.conv
    try:
        for n, fn in watched.items():
            setattr(F, n, watch(n, fn))
        if fallback:
            spatial.conv = lambda module, x, mesh=None, sizes=None: \
                module(x)
        for model, make in MODELS.items():
            seen[model] = []
            torch.manual_seed(0)
            net = bind_mesh(make(), mesh)
            for mod in net.modules():
                if isinstance(mod, nn.Conv2d) and mod.kernel_size[0] > 1:
                    mod.register_forward_pre_hook(
                        lambda m, a, model=model: seen[model].append(
                            f"nn.Conv2d {m.kernel_size} called"))
            x = torch.rand((2, S, S, 3), generator=torch.Generator()
                           .manual_seed(1)) * 2 - 1
            x, sizes = mesh.shard(x, (2,))
            if model == "resnet":
                x = x.permute(0, 3, 1, 2)
            net(x, group_sizes=sizes)
    finally:
        for n, fn in watched.items():
            setattr(F, n, fn)
        spatial.conv = conv
    return seen


def test_no_operation_spans_a_slab_outside_spatial(tmp_path):
    res = td.run_ranks(tmp_path, 2, run_walks, spatial=2)
    for fallback in (False, True):
        for seen in (walks[fallback] for walks in res):
            for model, calls in seen.items():
                if fallback and model != "unet":    # the UNet's convs are
                    assert calls, model             # spatial.conv3x3's
                else:
                    assert not calls, (model, calls[:4])


def test_a_slab_without_the_mesh_bound_raises():
    net = Unet2D(c=3, num_classes=2)
    x, sizes = torch.zeros((2, 16, 32, 3)), GroupSizes((2,), (2,), 32, 32)
    with pytest.raises(AssertionError, match="mesh bound"):
        net(x, group_sizes=sizes)
