"""Shared helpers of the tests that hold ust_run_tpu_torch against the JAX
package: JAX variables drawn with numpy from a seed (carried to the port
by ust_run_tpu_torch.convert), jitted JAX calls, layout changes, the BN
groupings of the step and the comparisons."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ust_run_tpu.models import UNet as JaxUNet
from ust_run_tpu_torch.convert import unet_state_dict_from_jax
from ust_run_tpu_torch.models import UNet


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def random_unet_variables(model, channels, size, seed):
    """{'params', 'batch_stats'} of `model` (a NHWC model taking `train`)
    at input (1, size, size, channels), drawn by `random_variables`."""
    return random_variables(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, channels)),
        train=False), seed)


def random_variables(init, seed):
    """The variables of the tree `init()` would make, with numpy draws:
    kernels U(-b, b), b = 1/sqrt(fan_in) (torch's default scale), BN/GN
    scales U(0.5, 1.5), small biases and running means, running vars
    U(0.5, 1.5). The tree comes from jax.eval_shape, so no JAX init
    runs."""
    shapes = jax.eval_shape(init)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            b = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            v = rng.uniform(-b, b, s.shape)
        elif "scale" in name or "var" in name:
            v = rng.uniform(0.5, 1.5, s.shape)
        else:                                   # biases, running means
            v = rng.normal(size=s.shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def unet_pair(channels, classes, pack, split, size, seed):
    """(JAX UNet, its variables, the port's UNet with the same weights)."""
    model = JaxUNet(n_channels=channels, n_classes=classes,
                    pack_l1=bool(pack), split_up=bool(split))
    variables = random_unet_variables(model, channels, size, seed)
    net = UNet(channels, classes)
    net.load_state_dict(unet_state_dict_from_jax(variables), strict=True)
    return model, variables, net


def init_fn(model, x, **kw):
    """`model.init` on input `x` with call keywords `kw`, for
    `random_variables`."""
    return lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw)


def loaded(net, sd):
    """`net` with the state_dict `sd` loaded, keys strict."""
    net.load_state_dict(sd, strict=True)
    return net


def jit_apply(model, variables, x, **kw):
    """model.apply under jax.jit, the keyword arguments closed over."""
    return jax.jit(lambda v, x: model.apply(v, x, **kw))(variables, x)


def assert_close(got, want, err_msg="", rtol=1e-4, atol=1e-4):
    """A port tensor against a JAX array."""
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=err_msg, rtol=rtol, atol=atol)


def assert_stats(net, sd):
    """The port's BN running statistics equal those of state_dict `sd`,
    at rtol/atol 1e-4."""
    n = 0
    for name, v in net.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert_close(v, sd[name].numpy(), name)
            n += 1
    assert n > 0


def nchw(x):
    """numpy NHWC -> a torch NCHW view (channels_last in memory)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


# (batch, JAX call keywords, port call keywords): 3 equal BN groups, or
# the step's unequal sizes with the last (LQ) group out of the fold
GROUPINGS = {
    "groups3": (6, dict(groups=3), dict(groups=3)),
    "sizes": (7, dict(group_sizes=(2, 2, 2, 1),
                      group_valid=jnp.asarray([True, True, True, False])),
              dict(group_sizes=(2, 2, 2, 1),
                   group_valid=torch.tensor([True, True, True, False]))),
}
