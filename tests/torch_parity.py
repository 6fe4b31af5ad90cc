"""Shared helpers of the tests that hold ust_run_tpu_torch against the JAX
package: JAX UNet variables drawn with numpy from a seed, carried to the
port by ust_run_tpu_torch.convert."""

import jax
import jax.numpy as jnp
import numpy as np

from ust_run_tpu.models import UNet as JaxUNet
from ust_run_tpu_torch.convert import unet_state_dict_from_jax
from ust_run_tpu_torch.models import UNet


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def random_unet_variables(model, channels, size, seed):
    """{'params', 'batch_stats'} of `model` with numpy draws: kernels
    U(-b, b), b = 1/sqrt(fan_in) (torch's default scale), BN scales
    U(0.5, 1.5), small biases and running means, running vars U(0.5, 1.5).
    The tree comes from jax.eval_shape, so no JAX init runs."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, channels)),
        train=False))
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
