"""The RNG kernel's key as a tensor (ops/rng.py), on the CPU: the plain
version with the key as a (2,) int32 tensor is bit-equal to the int-seed
one for keys with either word's high bit set; `uniform_fields` takes
either key; the weak augmentation keyed by a tensor equals the one keyed
by the int seed that the host generator drew."""

import numpy as np
import pytest
import torch

from torch_unroll import single_thread  # noqa: F401
from ust_run_tpu_torch.ops import augment, rng

pytestmark = pytest.mark.usefixtures("single_thread")

SEEDS = [0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 0x5EED_0F_F1E1D5,
         2 ** 63 + 12345, 2 ** 64 - 1]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,size", [(2, 8), (3, 37)])
def test_tensor_key_plain_is_the_int_key_plain(seed, n, size):
    key = torch.from_numpy(rng.key_words(seed))
    assert key.dtype == torch.int32 and key.shape == (2,)
    want = rng.uniform_batch_plain(n, size, seed)
    assert torch.equal(rng.uniform_batch_plain(n, size, key), want)
    out = torch.empty((n, size, size))
    assert torch.equal(rng.uniform_fields(out, key), want)
    assert torch.equal(rng.uniform_fields(torch.empty_like(out), seed), want)


def test_key_words_split_the_seed():
    seed = 0xFEDCBA98_76543210
    k0, k1 = rng.key_words(seed).view(np.uint32)
    assert (int(k0), int(k1)) == rng.split_seed(seed) \
        == (0x76543210, 0xFEDCBA98)
    g, h = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    assert np.array_equal(rng.draw_key(g), rng.key_words(rng.draw_seed(h)))


def test_tensor_key_is_checked():
    out = torch.empty((2, 4, 4))
    for bad in (torch.zeros(2, dtype=torch.int64),
                torch.zeros(3, dtype=torch.int32),
                torch.zeros(4, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="tensor key"):
            rng.uniform_fields(out, bad)


def test_weak_augmentation_by_key_or_host_generator():
    r = np.random.RandomState(0)
    img = torch.from_numpy(r.randint(0, 256, (2, 16, 16, 3)).astype(np.uint8))
    lab = torch.from_numpy(r.choice([0, 128, 255], (2, 16, 16, 1))
                           .astype(np.uint8))
    outs = []
    for by_key in (False, True):
        host = torch.Generator().manual_seed(4)
        key = torch.from_numpy(rng.draw_key(host)) if by_key \
            else rng.draw_seed(host)
        outs.append(augment.weak_augment_batch(
            img, lab, size=16, fillcolor=255,
            generator=torch.Generator().manual_seed(3), key=key))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
