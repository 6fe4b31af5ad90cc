"""The port's data ops against the JAX package on the CPU: the uniform-field
RNG's plain version, resampling, the weak and strong augmentation chains
(fed the draws re-derived from the JAX keys), FDA and CutMix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.ops import augment as jaug
from ust_run_tpu.ops import cutmix as jcut
from ust_run_tpu.ops import fda as jfda
from ust_run_tpu.ops import resample as jres
from ust_run_tpu_torch.ops import augment, cutmix, fda, resample, rng

pytestmark = pytest.mark.usefixtures("single_thread")


# ---------------------------------------------------------------- RNG ----

def _philox_numpy(counters, key):
    """Philox4x32-10 in numpy uint64 arithmetic (products < 2^64): an
    implementation independent of the port's 16-bit split."""
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    w0, w1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
    mask = np.uint64(0xFFFFFFFF)
    c = [np.asarray(v, np.uint64) for v in counters]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for r in range(10):
        if r:
            k0, k1 = (k0 + w0) & mask, (k1 + w1) & mask
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & mask]
    return c


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's Philox4x32-10 known-answer vectors."""
    words = rng.philox4x32_10(*(torch.tensor([v]) for v in counter), *key)
    assert tuple(int(w) for w in words) == want
    assert tuple(int(w[0]) for w in _philox_numpy(
        [[v] for v in counter], key)) == want


@pytest.mark.parametrize("n,size", [(3, 37), (4, 16)])
def test_uniform_plain_matches_numpy_philox(n, size):
    """Bit-equal to the independent numpy Philox, including the masked tail
    of a field whose S*S is not a multiple of 4 (37^2 = 1369)."""
    seed = 0x123456789ABCDEF
    u = rng.uniform_batch_plain(n, size, seed).numpy()
    quads = (size * size + 3) // 4
    q, f = np.meshgrid(np.arange(quads), np.arange(n))
    words = np.stack(_philox_numpy([q, f, 0 * q, 0 * q],
                                   rng.split_seed(seed)), -1)
    want = ((words.reshape(n, -1)[:, :size * size] >> np.uint64(8))
            .astype(np.float32) * np.float32(2.0 ** -24))
    np.testing.assert_array_equal(u.reshape(n, -1), want)


def test_uniform_batch_statistics_and_determinism():
    """The statistical bar of tests/test_ops.py:197-218, determinism per
    seed, and distinct fields."""
    g = torch.Generator().manual_seed(3)
    u = rng.uniform_batch(8, 128, generator=g, device="cpu").numpy()
    assert u.shape == (8, 128, 128) and u.dtype == np.float32
    assert u.min() >= 0.0 and u.max() < 1.0, (u.min(), u.max())
    assert abs(u.mean() - 0.5) < 0.01, u.mean()
    assert abs(u.std() - (1 / 12) ** 0.5) < 0.01, u.std()
    assert np.abs(u[0] - u[1]).max() > 0.1
    again = rng.uniform_batch(8, 128, generator=torch.Generator()
                              .manual_seed(3), device="cpu").numpy()
    np.testing.assert_array_equal(u, again)
    other = rng.uniform_batch(8, 128, generator=g, device="cpu").numpy()
    assert np.abs(u - other).max() > 0.1
    # the values lie on the 2^-24 grid
    np.testing.assert_array_equal(u * 2 ** 24, np.floor(u * 2 ** 24))


def test_uniform_fields_checks_its_output_tensor():
    with pytest.raises(ValueError):
        rng.uniform_fields(torch.empty(2, 4, 4, dtype=torch.float64), 1)
    with pytest.raises(ValueError):
        rng.uniform_fields(torch.empty(2, 4, 8), 1)
    with pytest.raises(ValueError):
        rng.uniform_fields(torch.empty(2, 8, 8)[:, ::2, ::2], 1)


# ----------------------------------------------------------- resample ----

def test_bilinear_and_nearest_gather_match_jax():
    """Exact against the JAX gathers, out-of-range coordinates included
    (edge clamp), for C=3 and C=1 sources in uint8."""
    r = np.random.RandomState(0)
    for c in (3, 1):
        img = r.randint(0, 256, (2, 24, 24, c)).astype(np.uint8)
        rows = r.uniform(-3, 27, (2, 20, 20)).astype(np.float32)
        cols = r.uniform(-3, 27, (2, 20, 20)).astype(np.float32)
        want = jax.vmap(jres.bilinear_gather)(img, rows, cols)
        got = resample.bilinear_gather(torch.from_numpy(img),
                                       torch.from_numpy(rows),
                                       torch.from_numpy(cols))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want_n = jax.vmap(jres.nearest_gather)(img, rows, cols)
        got_n = resample.nearest_gather(torch.from_numpy(img),
                                        torch.from_numpy(rows),
                                        torch.from_numpy(cols))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def test_gaussian_blur_and_kernel_match_jax():
    r = np.random.RandomState(1)
    img = r.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    sigma = np.asarray([0.3, 1.7], np.float32)
    kern_j = jax.vmap(lambda s: jres.gaussian_kernel(s, 3))(sigma)
    kern_t = resample.gaussian_kernel(torch.from_numpy(sigma), 3)
    np.testing.assert_allclose(kern_t.numpy(), np.asarray(kern_j),
                               rtol=1e-6, atol=1e-7)
    want = jax.vmap(jres.separable_gaussian_blur)(img, kern_j)
    got = resample.separable_gaussian_blur(torch.from_numpy(img), kern_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


def test_elastic_smoothing_matches_jax():
    """The band-matrix gaussian at sigma = 0.08*S, float32."""
    r = np.random.RandomState(2)
    raw = r.uniform(-1, 1, (4, 48, 48)).astype(np.float32)
    m = jnp.asarray(jaug._gauss_band_matrix(48, 0.08 * 48))
    want = jnp.einsum("ij,bjk->bik", m, raw, precision="highest")
    want = jnp.einsum("bik,lk->bil", want, m, precision="highest")
    got = augment.smooth_fields(torch.from_numpy(raw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------- augmentation ----

def _jax_weak_draws(key, n):
    """The per-sample draws of ust_run_tpu.ops.augment.weak_augment_sample,
    re-derived from the batch key exactly as weak_augment_batch splits it."""
    _, k_samples = jax.random.split(key)
    out = {k: [] for k in ("do_scale", "scale_w", "scale_h", "u_x", "u_y",
                           "do_rot", "deg", "do_flip", "do_el")}
    for k in jax.random.split(k_samples, n):
        ks = jax.random.split(k, 10)

        def u(i, lo=0.0, hi=1.0):
            return np.asarray(jax.random.uniform(ks[i], (), jnp.float32,
                                                 lo, hi))
        out["do_scale"].append(u(0) > 0.5)
        out["scale_w"].append(u(1, 1.0, 1.5))
        out["scale_h"].append(u(2, 1.0, 1.5))
        out["u_x"].append(u(3))
        out["u_y"].append(u(4))
        out["do_rot"].append(u(5) > 0.5)
        out["deg"].append(np.float32(jax.random.randint(ks[6], (), -20, 21)))
        out["do_flip"].append(u(7) > 0.5)
        out["do_el"].append(u(8) > 0.5)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("c,fill,seed", [(3, 255, 5), (1, 0, 9)])
def test_weak_chain_matches_jax(c, fill, seed):
    """Given the JAX draws and uniform fields, the composed weak chain gives
    the JAX package's rounded [0,255] images and masks. Allowed mismatch:
    at most 0.05% of image values, each by 1 (measured: 2 of 27648 values
    for C=3, 1 of 9216 for C=1). The frameworks' float32 sin/cos and
    coordinate arithmetic can differ in the last bit, so a bilinear value
    within rounding of .5 rounds the other way. Masks are exactly equal."""
    s, n = 48, 4
    r = np.random.RandomState(seed)
    img = r.randint(0, 256, (n, s, s, c)).astype(np.uint8)
    lab = r.choice([0, 128, 255], (n, s, s, 1)).astype(np.uint8)
    key = jax.random.PRNGKey(seed)
    want_img, want_lab = jaug.weak_augment_batch(key, img, lab, s, fill)
    k_fields, _ = jax.random.split(key)
    raw = np.asarray(jax.random.uniform(k_fields, (2 * n, s, s),
                                        jnp.float32)) * 2.0 - 1.0
    sm = augment.smooth_fields(torch.from_numpy(raw)) * (2.0 * s)
    got_img, got_lab = augment.weak_augment_apply(
        torch.from_numpy(img), torch.from_numpy(lab).float(), sm[:n], sm[n:],
        _jax_weak_draws(key, n), size=s, fillcolor=fill)
    diff = np.abs(got_img.numpy() - np.asarray(want_img))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-4, \
        ((diff > 0).sum(), diff.max())
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))


def test_strong_chain_matches_jax():
    """Brightness, contrast and blur with PIL rounding, given the JAX draws:
    exactly equal on the rounded outputs."""
    s, n = 40, 3
    r = np.random.RandomState(4)
    img = r.randint(0, 256, (n, s, s, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    radius = jaug.blur_radius_for(s)
    want = jaug.strong_augment_batch(key, img, 0.5, 1.5, radius)
    draws = {"u_bright": [], "u_contrast": [], "sigma": []}
    for k in jax.random.split(key, n):
        k0, k1, k2 = jax.random.split(k, 3)
        draws["u_bright"].append(np.asarray(jax.random.uniform(k0)))
        draws["u_contrast"].append(np.asarray(jax.random.uniform(k1)))
        draws["sigma"].append(np.asarray(jax.random.uniform(
            k2, (), jnp.float32, 0.1, 2.0)))
    draws = {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}
    got = augment.strong_augment_apply(torch.from_numpy(img), draws,
                                       min_v=0.5, max_v=1.5,
                                       blur_radius=radius)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_weak_batch_not_degenerate():
    """The bar of tests/test_ops.py:221 through the port's own draws and
    RNG (plain version on the CPU): no branch blanks out a sample."""
    img = torch.full((8, 64, 64, 3), 200, dtype=torch.uint8)
    lab = torch.full((8, 64, 64, 1), 128, dtype=torch.uint8)
    out, _ = augment.weak_augment_batch(
        img, lab, size=64, fillcolor=255,
        generator=torch.Generator().manual_seed(11),
        key=rng.draw_seed(torch.Generator().manual_seed(12)))
    black = (out.numpy() < 1.0).mean(axis=(1, 2, 3))
    assert black.max() < 0.5, black


def test_fda_matches_jax():
    r = np.random.RandomState(6)
    src = r.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32)
    trg = r.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jfda.fda_batch(key, src, trg, 0.7, 0.1)
    ratios = jax.random.uniform(key, (3,), jnp.float32) * 0.7
    got = fda.fda_apply(torch.from_numpy(src), torch.from_numpy(trg),
                        torch.from_numpy(np.array(ratios)), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ------------------------------------------------------------- cutmix ----

class _JaxBoxDraws:
    """Feeds cutmix_box_params the draws of ust_run_tpu.ops.cutmix.
    cutmix_box for one key, in the order the port asks for them."""

    def __init__(self, key):
        self.k_p, self.k_size, self.k = jax.random.split(key, 3)
        self.calls = 0
        self.ints = []

    def uniform(self, lo=0.0, hi=1.0):
        self.calls += 1
        if self.calls == 1:
            return np.float32(jax.random.uniform(self.k_p))
        if self.calls == 2:
            return np.float32(jax.random.uniform(self.k_size, (),
                                                 jnp.float32, lo, hi))
        k1, k2, k3, self.k = jax.random.split(self.k, 4)
        self.ints = [k2, k3]
        return np.float32(jax.random.uniform(k1, (), jnp.float32, lo, hi))

    def randint(self, lo, hi):
        return int(jax.random.randint(self.ints.pop(0), (), lo, hi))


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_cutmix_boxes_match_jax_given_same_draws(p):
    size = 40
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = jcut.cutmix_box(key, size, p)
        box = cutmix.cutmix_box_params(_JaxBoxDraws(key), size, p)
        got = cutmix.box_masks(size, torch.tensor([box]))[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_all_cover_box_matches_jax():
    size = 32
    region = np.zeros((size, size), np.float32)
    region[5:9, 11:20] = 1.0
    region[14, 3] = 1.0
    key = jax.random.PRNGKey(3)
    fallback = torch.tensor(cutmix.cutmix_box_params(_JaxBoxDraws(key),
                                                     size, p=1.0))
    for reg in (region, np.zeros_like(region)):
        want = jcut.all_cover_box(key, jnp.asarray(reg))
        got = cutmix.all_cover_box(torch.from_numpy(reg), fallback)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_cutmix_box_distribution():
    """Area in [0.02, 0.4]*S^2 before flooring, boxes inside the image,
    skipped with probability 1 - p."""
    draws = cutmix.HostDraws(torch.Generator().manual_seed(0))
    size = 64
    boxes = [cutmix.cutmix_box_params(draws, size, 0.5) for _ in range(400)]
    skipped = sum(b == (0, 0, 0, 0) for b in boxes)
    assert 150 < skipped < 250
    for y, x, h, w in boxes:
        assert y + h <= size and x + w <= size
        if h:
            assert h * w <= 0.4 * size * size
