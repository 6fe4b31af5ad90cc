"""ust_run_tpu_torch.ops.fused_conv against the JAX package's fused
BN+ReLU+conv3x3 (ust_run_tpu/ops/fused_conv.py) on the CPU: the port's
wrapper (its plain version on a CPU tensor) against the Pallas kernel in
interpret mode and against `xla_reference_chain`, at the shapes and
tolerances of tests/test_fused_conv.py (f32 1e-5; bf16 2e-2, one bf16 ulp
at these magnitudes, because the kernel applies BN in f32 and takes the
moments of the f32 accumulator where the chain rounds first). Inputs are
drawn with numpy from a seed and handed to both sides. The CUDA kernel
against its plain version on a card is in tests/test_torch_package.py,
which the card's JAX-free environment can collect."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ust_run_tpu.ops import fused_conv as jfc
from ust_run_tpu_torch.ops import fused_conv as fc

SHAPES = [(2, 16, 16, 8, 8), (1, 32, 24, 16, 8), (1, 16, 16, 64, 16)]


def _inputs(b, h, w, c, co, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(b, h, w, c)).astype(np.float32),
            rng.uniform(0.5, 1.5, (b, c)).astype(np.float32),
            (rng.normal(size=(b, c)) * 0.3).astype(np.float32),
            (rng.normal(size=(3, 3, c, co)) * 0.1).astype(np.float32))


def _port(y, inv, shift, wk, dtype, fn=fc.bn_relu_conv3x3):
    ty = torch.from_numpy(y).to(dtype)
    out = fn(ty, torch.from_numpy(inv), torch.from_numpy(shift),
             torch.from_numpy(wk))
    return [o.float().numpy() for o in out]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_kernel_and_chain(dtype, shape):
    y, inv, shift, wk = _inputs(*shape)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jy = jnp.asarray(y).astype(jdt)
    ours = _port(y, inv, shift, wk, dtype)
    kern = jfc.bn_relu_conv3x3(jy, jnp.asarray(inv), jnp.asarray(shift),
                               jnp.asarray(wk), block_rows=8, interpret=True)
    chain = jfc.xla_reference_chain(jy, jnp.asarray(inv),
                                    jnp.asarray(shift), jnp.asarray(wk))
    for ref in (kern, chain):
        for a, r in zip(ours, ref):
            np.testing.assert_allclose(a, np.asarray(r, np.float32),
                                       **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_chain_matches_jax_chain(dtype):
    y, inv, shift, wk = _inputs(*SHAPES[1], seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ours = _port(y, inv, shift, wk, dtype, fn=fc.reference_chain)
    ref = jfc.xla_reference_chain(jnp.asarray(y).astype(jdt),
                                  jnp.asarray(inv), jnp.asarray(shift),
                                  jnp.asarray(wk))
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(r, np.float32),
                                   **_tol(dtype))


def test_edge_rows_are_zero_padded():
    """Zero padding lives in the post-BN domain: on all-ones input the
    corners see 4 taps, the edges 6 and the interior 9 (x C)."""
    b, h, w, c, co = 1, 16, 16, 8, 8
    ones = torch.ones((b, h, w, c))
    out, m1, m2 = fc.bn_relu_conv3x3(ones, torch.ones((b, c)),
                                     torch.zeros((b, c)),
                                     torch.ones((3, 3, c, co)))
    ref, _, _ = jfc.xla_reference_chain(
        jnp.ones((b, h, w, c)), jnp.ones((b, c)), jnp.zeros((b, c)),
        jnp.ones((3, 3, c, co)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[0, 0, 0, 0] == 4 * c
    assert out[0, 0, 5, 0] == 6 * c
    assert out[0, 5, 5, 0] == 9 * c
    np.testing.assert_allclose(m1.numpy(), out.mean(dim=(1, 2)).numpy(),
                               rtol=1e-6)


def test_wrapper_checks_and_cpu_path():
    """A CPU tensor takes the plain version and launches nothing; shapes
    and dtypes the kernel does not take raise."""
    y, inv, shift, wk = (torch.from_numpy(a) for a in _inputs(*SHAPES[0]))
    before = fc.launches
    out = fc.bn_relu_conv3x3(y, inv, shift, wk)
    plain = fc.bn_relu_conv3x3_plain(y, inv, shift, wk)
    for a, p in zip(out, plain):
        assert torch.equal(a, p)
    assert fc.launches == before
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fc.bn_relu_conv3x3(y.half(), inv, shift, wk)
    with pytest.raises(ValueError, match="w must be"):
        fc.bn_relu_conv3x3(y, inv, shift, wk[:, :, :4])
    with pytest.raises(ValueError, match="inv_n must be"):
        fc.bn_relu_conv3x3(y, inv[:1], shift, wk)
    with pytest.raises(ValueError, match="unsupported device"):
        fc.bn_relu_conv3x3(y.to("meta"), inv.to("meta"), shift.to("meta"),
                           wk.to("meta"))


# (dtype, C, Co, H, W) -> (route, tile rows, columns, channels, K chunk,
# tiles per sample), worked out by hand from csrc/fused_conv.cu's rule
@pytest.mark.parametrize("dtype,c,co,h,w,want", [
    (torch.bfloat16, 64, 64, 256, 256, (1, 16, 16, 64, 64, 256)),
    (torch.bfloat16, 256, 256, 64, 64, (1, 16, 16, 128, 64, 16)),
    (torch.bfloat16, 136, 200, 40, 50, (1, 16, 16, 128, 64, 12)),
    (torch.bfloat16, 64, 72, 19, 37, (1, 16, 16, 128, 64, 6)),
    (torch.bfloat16, 8, 8, 16, 16, (1, 16, 16, 64, 64, 1)),
    (torch.bfloat16, 3, 70, 19, 37, (0, 8, 16, 64, 32, 9)),
    (torch.bfloat16, 64, 70, 19, 37, (0, 8, 16, 64, 32, 9)),
    (torch.bfloat16, 12, 64, 32, 24, (0, 8, 16, 64, 32, 8)),
    (torch.float32, 64, 64, 256, 256, (0, 8, 16, 64, 16, 512)),
    (torch.float32, 3, 70, 19, 37, (0, 8, 16, 64, 16, 9))])
def test_plan_routes_by_shape(dtype, c, co, h, w, want):
    """The TMA route takes bf16 with 16-byte channel rows (C and Co
    multiples of 8), N tile 64 up to Co = 64 and 128 above; everything
    else, f32 included, takes the WMMA route. `tiles` sizes the moment
    scratch (2, B, tiles, Co): ceil(H / rows) * ceil(W / columns)."""
    assert tuple(fc.plan(dtype, c, co, h, w)) == want
