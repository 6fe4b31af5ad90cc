"""Parameter gradients of the port's UNet against jax.grad of the JAX UNet
(CPU, float32), weights carried by ust_run_tpu_torch.convert.

Tolerance: rtol 1e-3 per element, with an absolute floor of 1e-5 of the
tensor's largest gradient. The gradient is discontinuous at ReLU inputs
of 0 and at max-pool ties. With 31M parameters and random draws, one
ReLU input often lies within float32 rounding of 0 and the two
frameworks' forwards (which agree to ~1e-5) resolve it differently; one
flipped unit at the 4x4 level moves some gradients by ~10% of their
largest entry. (Checked at such a draw: the port agreed with an
independent float64 F.batch_norm UNet to 7e-6, the JAX UNet did not.)
The seed below draws weights and inputs with no such flip, so the
comparison checks the algorithm, not that tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_tree, unet_pair
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu_torch.convert import unet_state_dict_from_jax

pytestmark = pytest.mark.usefixtures("single_thread")


@pytest.mark.parametrize("c,k,pack,split", [(3, 2, 1, 1), (1, 4, 0, 0)])
def test_unet_grads_match_jax(c, k, pack, split):
    size, batch, groups = 32, 4, 2
    model, variables, net = unet_pair(c, k, pack, split, size, seed=4)
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (batch, size, size, c)).astype(np.float32)
    r = rng.normal(size=(batch, size, size, k)).astype(np.float32)

    def jax_loss(params):
        out, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, groups=groups,
            mutable=["batch_stats"])
        return jnp.sum(out * r)

    grads_j = jax.jit(jax.grad(jax_loss))(variables["params"])
    net.train()
    out_t = net(torch.from_numpy(x), groups=groups)
    torch.sum(out_t * torch.from_numpy(r)).backward()

    g_sd = unet_state_dict_from_jax({"params": np_tree(grads_j),
                                     "batch_stats": variables["batch_stats"]})
    for name, p in net.named_parameters():
        want = g_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
