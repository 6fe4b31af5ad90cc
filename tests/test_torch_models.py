"""The port's GroupedBatchNorm, UNet forward and weight bridge against the
JAX package (CPU, float32). Inputs are made with numpy from a seed; the
JAX weights go to the port through ust_run_tpu_torch.convert."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import unet_pair
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.models.layers import GroupedBatchNorm as JaxGBN
from ust_run_tpu.utils.torch_import import unet_from_torch_state_dict
from ust_run_tpu_torch.convert import unet_state_dict_from_jax
from ust_run_tpu_torch.models import GroupedBatchNorm, ResNet, UNet

pytestmark = pytest.mark.usefixtures("single_thread")


def _bn_pair(c, seed):
    rng = np.random.RandomState(seed)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    jvars = {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean, "var": var}}
    bn = GroupedBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    return jvars, bn


@pytest.mark.parametrize("case", ["groups3", "sizes_last_invalid",
                                  "sizes_all_valid", "groups3_relu",
                                  "sizes_last_invalid_relu"])
def test_grouped_bn_matches_jax(case):
    """Outputs, the gradients of sum(y * r) for the input, weight and bias,
    and running stats, equal groups and unequal sizes with the last group
    masked out of the fold, at 1e-5; `_relu` cases with the ReLU fused
    into the port's layer against jax.nn.relu after the JAX one; then
    eval mode."""
    c, h, w = 8, 5, 6
    relu = case.endswith("_relu")
    rng = np.random.RandomState(1)
    if case.startswith("groups3"):
        n, kw_j, kw_t = 12, dict(groups=3), dict(groups=3)
    else:
        sizes = (4, 4, 4, 4, 4, 1)
        valid = np.array([1, 1, 1, 1, 1, case == "sizes_all_valid"], bool)
        n = sum(sizes)
        kw_j = dict(group_sizes=sizes, group_valid=jnp.asarray(valid))
        kw_t = dict(group_sizes=sizes, group_valid=torch.from_numpy(valid))
    x = (rng.normal(size=(n, h, w, c)) * 2 + 0.5).astype(np.float32)
    r = rng.normal(size=(n, h, w, c)).astype(np.float32)
    jvars, bn = _bn_pair(c, 2)
    act = jax.nn.relu if relu else (lambda t: t)

    def jloss(params, xj):
        y, upd = JaxGBN().apply({"params": params, "batch_stats":
                                 jvars["batch_stats"]}, xj, train=True,
                                mutable=["batch_stats"], **kw_j)
        y = act(y)
        return jnp.sum(y * r), (y, upd)

    (_, (y_j, upd)), (g_j, gx_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jvars["params"],
                                             jnp.asarray(x))
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y_t = bn(xt, relu=relu, **kw_t)
    (y_t * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_t.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y_j), **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_j), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(g_j["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(g_j["bias"]), **tol)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, ours).numpy(),
                                   np.asarray(upd["batch_stats"][theirs]),
                                   **tol)
    # eval mode normalises with the (updated) running statistics
    bn.eval()
    y_e = bn(torch.from_numpy(x).permute(0, 3, 1, 2), relu=relu)
    y_je = act(JaxGBN().apply({"params": jvars["params"], **upd},
                              jnp.asarray(x), train=False))
    np.testing.assert_allclose(y_e.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y_je), **tol)


def _unfused():
    """GroupedBatchNorm with the ReLU after it rather than inside it: the
    layer as models call it with relu=False, then F.relu."""
    forward = GroupedBatchNorm.forward

    def bn_then_relu(self, x, *args, relu=False, **kw):
        y = forward(self, x, *args, **kw)
        return F.relu(y) if relu else y
    return bn_then_relu


@pytest.mark.parametrize("model", ["unet", "resnet"])
def test_fused_relu_models_equal_unfused(model, monkeypatch):
    """The UNet (DoubleConv) and the ResNet (stem, Bottleneck bn1 and
    bn2), whose ReLUs run inside their BatchNorms, give the forward and
    every gradient of the same models with each ReLU after its layer, at
    the JAX parity tests' seeds (no ReLU input at 0), within 1e-5 in norm:
    the forwards are bit-equal, but the gradient reaching a layer is laid
    out in memory as the ReLU's backward or the layer's own backward
    leaves it, and the CPU's sums over it follow the layout (UNet 2.8e-6,
    ResNet 0)."""
    if model == "unet":
        net = unet_pair(3, 2, 0, 0, 32, seed=5)[2]
        x = torch.from_numpy(np.random.RandomState(7).uniform(
            -1, 1, (6, 32, 32, 3)).astype(np.float32))
        call = lambda m: m(x, groups=3)                     # noqa: E731
    else:
        net = ResNet((1, 1, 1, 1)).init_weights_(
            torch.Generator().manual_seed(12))
        x = torch.from_numpy(np.random.RandomState(12).uniform(
            -1, 1, (6, 3, 40, 40)).astype(np.float32))
        call = lambda m: m(x, groups=3)[-1]                 # noqa: E731
    nets = [net, copy.deepcopy(net)]
    outs = []
    for i, m in enumerate(nets):
        m.train()
        with monkeypatch.context() as mp:
            if i == 1:
                mp.setattr(GroupedBatchNorm, "forward", _unfused())
            out = call(m)
            out.square().mean().backward()
        outs.append([out.detach()] + [p.grad for p in m.parameters()])
    errs = [((a - b).norm() / b.norm()).item() for a, b in zip(*outs)]
    assert max(errs) < 1e-5, errs


@pytest.mark.parametrize("c,k,pack,split,size", [
    (3, 2, 1, 1, 32), (3, 2, 0, 0, 32), (1, 2, 1, 0, 36), (1, 4, 0, 1, 32),
])
def test_unet_forward_matches_jax(c, k, pack, split, size):
    """Train-mode (3 BN groups) and eval forwards at atol 1e-4, and the
    running statistics after the train forward at 1e-4, against the JAX
    UNet in each layout (pack_l1, split_up). Size 36 takes Up's
    pad-to-match branch."""
    model, variables, net = unet_pair(c, k, pack, split, size, seed=c + k)
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (6, size, size, c)).astype(np.float32)

    out_j, upd = model.apply(variables, jnp.asarray(x), train=True,
                             groups=3, mutable=["batch_stats"])
    net.train()
    with torch.no_grad():
        out_t = net(torch.from_numpy(x), groups=3)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-4)
    new_sd = unet_state_dict_from_jax({"params": variables["params"],
                                       **upd})
    for name, v in net.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), new_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=name)

    net.eval()
    with torch.no_grad():
        out_te = net(torch.from_numpy(x))
    out_je = model.apply({"params": variables["params"], **upd},
                         jnp.asarray(x), train=False)
    np.testing.assert_allclose(out_te.numpy(), np.asarray(out_je),
                               rtol=1e-4, atol=1e-4)


def test_weight_bridge_round_trip_is_exact():
    """port state_dict -> JAX (torch_import) -> port (convert) is exact,
    and the module names are upstream's torch keys."""
    net = UNet(3, 2).init_weights_(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i, (name, b) in enumerate(net.named_buffers()):
            if "running" in name:
                b.uniform_(0.5, 1.5,
                           generator=torch.Generator().manual_seed(i))
    sd = net.state_dict()
    assert "inc.double_conv.0.weight" in sd
    assert "down4.maxpool_conv.1.double_conv.4.running_var" in sd
    assert "up1.up.weight" in sd and "up4.conv.double_conv.3.weight" in sd
    assert "outc.conv.bias" in sd
    back = unet_state_dict_from_jax(unet_from_torch_state_dict(sd))
    assert set(back) == set(sd)
    for name, v in sd.items():
        assert torch.equal(back[name], v), name
    n_params = sum(p.numel() for p in net.parameters())
    assert 31_000_000 < n_params < 31_100_000, n_params
