"""The weak and strong augmentation of each package with its own random
draws (the JAX key stream against the port's generators; the port's RNG
kernel through its plain version on the CPU), in distribution: the same 8
synthetic fundus images at patch 64 go through 40 batches of each, and
the per-sample mean, mean square and fill share (pixels at 0, the
rotation's and the elastic field's fill) of the normalised outputs must
agree within 4 standard errors of their difference. The chains
themselves are held value for value, given the same draws, by
tests/test_torch_ops.py."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ust_run_tpu.ops import augment as jaug
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.ops import augment

S, N, CALLS = 64, 8, 40


def _images(root):
    d = os.path.join(root, "Domain1", "train", "ROIs")
    names = sorted(os.listdir(os.path.join(d, "image")))[:N]
    img = np.stack([np.asarray(Image.open(os.path.join(d, "image", n)))
                    for n in names])
    lab = np.stack([np.asarray(Image.open(os.path.join(d, "mask", n)))
                    for n in names])
    return img.astype(np.uint8), lab[..., None].astype(np.uint8)


def _stats(x255):
    x = np.asarray(x255, np.float64).reshape(len(x255), -1)
    z = x / 127.5 - 1.0
    return {"mean": z.mean(1), "ms": (z * z).mean(1),
            "fill": (x == 0).mean(1)}


def _jax_samples(img, lab):
    weak = jax.jit(lambda k: jaug.weak_augment_batch(k, img, lab, S, 255)[0])
    out = {"weak": [], "strong": []}
    for i in range(CALLS):
        kw, ks = jax.random.split(jax.random.PRNGKey(i))
        w = weak(kw)
        out["weak"].append(np.asarray(w))
        out["strong"].append(np.asarray(jaug.strong_augment_batch(
            ks, w, 0.5, 1.5, jaug.blur_radius_for(S))))
    return out


def _port_samples(img, lab):
    gen = torch.Generator().manual_seed(0)
    host = torch.Generator().manual_seed(1)
    img_t, lab_t = torch.from_numpy(img), torch.from_numpy(lab)
    out = {"weak": [], "strong": []}
    for _ in range(CALLS):
        w, _ = augment.weak_augment_batch(img_t, lab_t, size=S, fillcolor=255,
                                          generator=gen, host_generator=host)
        out["weak"].append(w.numpy())
        out["strong"].append(augment.strong_augment_batch(
            w, min_v=0.5, max_v=1.5, blur_radius=augment.blur_radius_for(S),
            generator=gen).numpy())
    return out


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    root = generate("fundus", str(tmp_path_factory.mktemp("data")),
                    n_train=N, n_test=1, size=S, seed=0)
    img, lab = _images(root)
    return _jax_samples(img, lab), _port_samples(img, lab)


@pytest.mark.parametrize("chain", ["weak", "strong"])
def test_augmentation_distribution_matches_jax(samples, chain):
    j, p = (_stats(np.concatenate(s[chain])) for s in samples)
    for k in ("mean", "ms", "fill"):
        se = np.sqrt(j[k].var() / j[k].size + p[k].var() / p[k].size)
        assert abs(j[k].mean() - p[k].mean()) <= 4 * se, \
            (chain, k, j[k].mean(), p[k].mean(), se)
