"""The port's dilated ResNet and DeepLabV2 against the JAX package on the
CPU, float32, with resize_align_corners, the weight bridges of every zoo
family, the JAX package reading the port's DeepLab best-model file and
the ImageNet backbone overlay. (The Unet2D family, DSBN and WideResNet
are in test_torch_zoo_unet2d.py.)

Inputs and weights are drawn with numpy from a seed; the JAX variables go
to the port through ust_run_tpu_torch.convert. Train-mode forwards run
with 3 BN groups or with unequal `group_sizes` whose last group is left
out of the running-statistic fold (the student's call in the step);
outputs and the updated running statistics are compared at rtol/atol
1e-4 (DeepLab's train-mode logits: see its test), then the eval-mode
forward with the updated statistics. ResNet's parameter gradients of a
CE+Dice loss are compared in norm at rtol 1e-4, at seeds where no ReLU
decision flips between the frameworks. JAX's DeepLabV2 fixes its
backbone to ResNet-50/101, so DeepLab runs at ResNet-50 and 32 px.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (GROUPINGS, assert_close, assert_stats, init_fn,
                          jit_apply, loaded, nchw, nhwc, random_variables)
from ust_run_tpu.engine import checkpoint as jax_ckpt
from ust_run_tpu.models import DeepLabV2 as JaxDeepLab
from ust_run_tpu.models import unet2d as junet2d
from ust_run_tpu.models.deeplab import resize_align_corners as jax_resize
from ust_run_tpu.models.resnet import ResNet as JaxResNet
from ust_run_tpu.models.wrn import build_WideResNet as jax_wrn
from ust_run_tpu.utils import losses as JL
from ust_run_tpu.utils import torch_import
from ust_run_tpu_torch import convert
from ust_run_tpu_torch.config import build_parser, config_from_args
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.engine import checkpoint as ckpt
from ust_run_tpu_torch.engine.trainer import Trainer
from ust_run_tpu_torch.models import (DeepLabV2, ResNet, build_WideResNet,
                                      unet2d)
from ust_run_tpu_torch.models.deeplab import resize_align_corners
from ust_run_tpu_torch.utils import losses as L


@pytest.mark.parametrize("grouping,layers,seed", [
    ("groups3", (1, 1, 1, 1), 12), ("sizes", (2, 1, 2, 1), 37)])
def test_resnet_matches_jax(grouping, layers, seed):
    """Stage outputs c1..c4 in train mode, the running statistics, the
    parameter gradients of a CE+Dice loss on a fixed 1x1 projection of c4,
    then eval mode. At these depths a ReLU input within float32 rounding
    of 0 often resolves differently in the two frameworks (at 22 of 24
    seeds tried, moving some gradients by 1e-3 to 2e-2 in norm, while
    each framework alone sits within 1e-5 of a float64 run of the same
    weights); the seeds are drawn so that no decision flips, and there
    port and JAX agree within 1.3e-5."""
    n, kw_j, kw_t = GROUPINGS[grouping]
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 40, 40, 3)).astype(np.float32)
    proj = rng.normal(size=(2048, 2)).astype(np.float32) / 45.0
    target = rng.randint(0, 2, (n, 5, 5))
    model = JaxResNet(layers=layers)
    v = random_variables(init_fn(model, x, train=False), seed + 10)
    net = loaded(ResNet(layers), convert.resnet_state_dict_from_jax(v))

    def jloss(params):
        feats, upd = model.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 jnp.asarray(x), train=True,
                                 mutable=["batch_stats"], **kw_j)
        logits = feats[-1] @ proj
        return JL.ce_plus_dice(logits, jnp.asarray(target), multilabel=False,
                               n_classes=2), (feats, upd)

    (loss_j, (feats_j, upd)), g_j = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])
    net.train()
    feats_t = net(nchw(x), **kw_t)
    loss_t = L.ce_plus_dice(nhwc(feats_t[-1]) @ torch.from_numpy(proj),
                            torch.from_numpy(target), multilabel=False,
                            n_classes=2)
    loss_t.backward()
    for i, (a, b) in enumerate(zip(feats_t, feats_j)):
        assert_close(nhwc(a), b, f"c{i + 1}")
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    new_sd = convert.resnet_state_dict_from_jax(
        {"params": v["params"], **upd})
    assert_stats(net, new_sd)
    g_sd = convert.resnet_state_dict_from_jax(
        {"params": g_j, "batch_stats": v["batch_stats"]})
    for name, p in net.named_parameters():
        want = g_sd[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - want) / np.linalg.norm(want)
        assert err < 1e-4, (name, err)

    net.eval()
    with torch.no_grad():
        out_e = net(nchw(x))[-1]
    want_e = jit_apply(model, {"params": v["params"], **upd}, x,
                    train=False)[-1]
    assert_close(nhwc(out_e), want_e)


@pytest.mark.parametrize("case", ["groups3", "sizes", "tta"])
def test_deeplab_matches_jax(case):
    """DeepLabV2(resnet50) at 32 px: train-mode logits and running
    statistics in each grouping, then eval mode; `tta`: the eval-mode
    five-scale, flipped test augmentation. The train-mode logits (up to
    1.3 in magnitude) are held at atol 6e-4: through 53 convolutions whose
    BN groups hold 2 images, or the single LQ image, of 4x4 pixels,
    float32 rounding alone moves them by up to 1.3e-4 (groups3) and
    1.8e-4 (sizes) in the JAX package itself (its jitted against its eager
    forward, same weights and inputs); the port sits at 1.9e-4 and
    4.3e-4."""
    rng = np.random.RandomState(3)
    n, kw_j, kw_t = GROUPINGS["groups3" if case == "tta" else case]
    x = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    model = JaxDeepLab(backbone="resnet50", nclass=2)
    v = random_variables(init_fn(model, x[:1], train=False), 4)
    net = loaded(DeepLabV2("resnet50", 2),
                convert.deeplab_state_dict_from_jax(v))
    if case == "tta":
        net.eval()
        with torch.no_grad():
            got = net(torch.from_numpy(x[:2]), tta=True)
        want = jit_apply(model, v, x[:2], train=False, tta=True)
        assert got.shape == (2, 32, 32, 2)
        assert_close(got, want)
        return
    out_j, upd = jit_apply(model, v, x, train=True, mutable=["batch_stats"],
                        **kw_j)
    net.train()
    with torch.no_grad():
        out_t = net(torch.from_numpy(x), **kw_t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-4,
                               atol=6e-4)
    assert_stats(net, convert.deeplab_state_dict_from_jax(
        {"params": v["params"], **upd}))
    net.eval()
    with torch.no_grad():
        out_e = net(torch.from_numpy(x))
    assert_close(out_e, jit_apply(model, {"params": v["params"], **upd}, x,
                         train=False))


def test_resize_align_corners_matches_jax():
    x = np.random.RandomState(0).randn(2, 9, 13, 3).astype(np.float32)
    for h2, w2 in [(17, 29), (5, 7), (9, 13), (1, 4), (4, 1), (1, 1),
                   (64, 64)]:
        got = nhwc(resize_align_corners(nchw(x), h2, w2))
        assert_close(got, jax_resize(jnp.asarray(x), h2, w2), f"{(h2, w2)}")
    one = np.random.RandomState(1).randn(1, 1, 1, 2).astype(np.float32)
    assert_close(nhwc(resize_align_corners(nchw(one), 3, 5)),
           jax_resize(jnp.asarray(one), 3, 5))


def _tree_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("family", ["resnet", "deeplab", "unet2d",
                                    "unet2d_mt", "wrn"])
def test_bridge_round_trips_are_exact(family):
    """torch_import.*_from_torch_state_dict(convert.*_from_jax(v)) == v,
    and the port's module loads the state_dict with strict keys."""
    x = np.zeros((1, 32, 32, 3), np.float32)
    if family == "resnet":
        model, net = JaxResNet(layers=(3, 4, 6, 3)), ResNet((3, 4, 6, 3))
        to_t, to_j = convert.resnet_state_dict_from_jax, \
            lambda sd: torch_import.resnet_from_torch_state_dict(
                sd, "resnet50")
    elif family == "deeplab":
        model, net = JaxDeepLab(backbone="resnet50"), DeepLabV2("resnet50")
        to_t, to_j = convert.deeplab_state_dict_from_jax, \
            lambda sd: torch_import.deeplab_from_torch_state_dict(
                sd, "resnet50")
    elif family.startswith("unet2d"):
        cls = "Unet2D_MT" if family == "unet2d_mt" else "Unet2D"
        model, net = getattr(junet2d, cls)(c=3, n=8), \
            getattr(unet2d, cls)(c=3, n=8)
        to_t = convert.unet2d_state_dict_from_jax
        to_j = torch_import.unet2d_from_torch_state_dict
    else:
        model = jax_wrn(depth=10).build(num_classes=5, in_channel=3)
        net = build_WideResNet(depth=10).build(num_classes=5, in_channel=3)
        to_t = convert.wrn_state_dict_from_jax
        to_j = lambda sd: torch_import.wrn_from_torch_state_dict(  # noqa
            sd, depth=10)
    v = random_variables(init_fn(model, x, train=False), 14)
    sd = to_t(v)
    net.load_state_dict(sd, strict=True)
    _tree_equal(to_j(sd), v)


def _deeplab_r50_state_dict(seed):
    g = torch.Generator().manual_seed(seed)
    net = DeepLabV2("resnet50", 2).init_weights_(g)
    with torch.no_grad():
        for name, b in net.named_buffers():
            if name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=g)
            elif name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=g)
    return net.state_dict()


def test_jax_reads_port_deeplab_best_model(tmp_path):
    """The port's best-model file of deeplabv2_r50 (a bare state_dict) is
    read by the JAX package's load_best_model into the JAX DeepLabV2's
    tree, with every tensor carried exactly."""
    sd = _deeplab_r50_state_dict(15)
    path = str(tmp_path / "deeplabv2_r50_avg_dice_best_model.pth")
    ckpt.atomic_save(path, ckpt.host_copy(sd))
    v = jax_ckpt.load_best_model(path, model="deeplabv2_r50")
    shapes = jax.eval_shape(init_fn(JaxDeepLab(backbone="resnet50"),
                                  np.zeros((1, 32, 32, 3), np.float32),
                                  train=False))
    assert jax.tree.structure(v) == jax.tree.structure(
        jax.tree.map(lambda s: 0, shapes))
    back = convert.deeplab_state_dict_from_jax(v)
    for k, t in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], t), k


@pytest.mark.parametrize("wrapped", [False, True])
def test_backbone_overlay_matches_jax(tmp_path, caplog, wrapped):
    """A torchvision-layout resnet50.pth written from a seeded port
    backbone (with `fc.*`, without num_batches_tracked as torchvision's
    ImageNet files; `wrapped`: under `state_dict`) goes into both backbones
    of a --model deeplabv2_r50 Trainer, equal to what the JAX package's
    overlay_pretrained_backbone makes of the same file; the heads keep
    their init."""
    sd = {k: v for k, v in _deeplab_r50_state_dict(16).items()
          if k.startswith("backbone.")
          and not k.endswith("num_batches_tracked")}
    pth = {k[len("backbone."):]: v for k, v in sd.items()}
    pth["fc.weight"] = torch.zeros(1000, 2048)
    pth["fc.bias"] = torch.zeros(1000)
    os.makedirs(tmp_path / "pre")
    torch.save({"state_dict": pth} if wrapped else pth,
               str(tmp_path / "pre" / "resnet50.pth"))

    shapes = init_fn(JaxDeepLab(backbone="resnet50"),
                   np.zeros((1, 32, 32, 3), np.float32), train=False)
    v = random_variables(shapes, 17)
    jv = torch_import.overlay_pretrained_backbone(
        v, str(tmp_path / "pre" / "resnet50.pth"), "resnet50")
    want = convert.deeplab_state_dict_from_jax(jv)

    root = generate("fundus", str(tmp_path / "data"), n_train=5, n_test=1,
                    size=32, seed=0)
    argv = ["--dataset", "fundus", "--data_root", root, "--lb_num", "3",
            "--model", "deeplabv2_r50", "--patch_override", "32",
            "--pretrained_root", str(tmp_path / "pre"), "--model_root",
            str(tmp_path / "m"), "--device", "cpu"]
    cfg = config_from_args(build_parser().parse_args(argv)).resolve()
    head = DeepLabV2("resnet50", 2).init_weights_(
        torch.Generator().manual_seed(cfg.seed))
    with caplog.at_level("INFO"):
        tr = Trainer(cfg, str(tmp_path / "snap"))
    assert any("loaded ImageNet backbone weights" in r.message
               for r in caplog.records)
    for model in (tr.state.student, tr.state.teacher):
        got = model.state_dict()
        for k in sd:
            assert torch.equal(got[k], sd[k]), k
            assert torch.equal(got[k], want[k]), k
    # the student's head is its own init (first draw of the seed)
    assert torch.equal(tr.state.student.classifier[0].weight,
                       head.classifier[0].weight)
    tr.close()
