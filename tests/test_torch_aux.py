"""The port's auxiliary modules that no entry point reaches, each held
against the JAX package's function on the same seeded inputs, on the CPU:

  * the framework-free copies (data/dl_utils.py's numpy helpers,
    data/transform.py, data/ssda.py, data/extra_transforms.py): the same
    draws from the same seeds (numpy, `random`, numpy Generators) give
    equal outputs, array for array;
  * the torch ports (dl_utils.cross_entropy2d, the auxiliary losses, the
    per-label dice forms): float32, rtol 1e-5 and atol 1e-6; the numpy
    dice and the ramps: equal.

The cases mirror tests/test_aux_components.py, test_ssda.py,
test_extra_transforms.py, test_losses.py, test_metrics.py and
test_ramps.py.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ust_run_tpu.data import dl_utils as jdl
from ust_run_tpu.data import extra_transforms as jX
from ust_run_tpu.data import transform as jT
from ust_run_tpu.data.ssda import ID_TO_TRAINID
from ust_run_tpu.data.ssda import SSDADataset as JaxSSDA
from ust_run_tpu.utils import losses as jL
from ust_run_tpu.utils import metrics as jM
from ust_run_tpu.utils import ramps as jR
from ust_run_tpu_torch.data import dl_utils
from ust_run_tpu_torch.data import extra_transforms as X
from ust_run_tpu_torch.data import transform as T
from ust_run_tpu_torch.data.ssda import SSDADataset
from ust_run_tpu_torch.utils import losses as L
from ust_run_tpu_torch.utils import metrics as M
from ust_run_tpu_torch.utils import ramps as R

RTOL, ATOL = 1e-5, 1e-6


def assert_same(a, b, path="out"):
    """Equal nests of dicts, sequences, PIL images, arrays and numbers."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, Image.Image):
        assert a.mode == b.mode and a.size == b.size, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, path)
    else:
        assert a == b, path


def seeded(fn, module, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn(module)


def sample(size=32):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
    mask = rng.choice([0, 128, 255], (size, size)).astype(np.uint8)
    return {"image": Image.fromarray(img), "label": Image.fromarray(mask),
            "img_name": "t.png"}


def boundary_mask():
    m = np.zeros((40, 40, 2), np.uint8)
    m[10:30, 10:30, 0] = 1
    m[15:25, 15:25, 1] = 1
    return m


def array_sample():
    s = sample()
    s["image"] = np.asarray(s["image"])       # eraser takes an array
    return s


# tests/test_extra_transforms.py's calls, each run from a seed
EXTRA = {
    "salt_pepper": lambda X: X.add_salt_pepper_noise()(sample()),
    "adjust_light": lambda X: X.adjust_light()(sample()),
    "reverse_aug": lambda X: X.reverse_aug(3, 3, 0.5, 1.5)(
        sample()["image"], sample()["image"]),
    "eraser": lambda X: X.eraser()(array_sample()),
    "cutout": lambda X: X.cutout()(sample()),
    "flip": lambda X: X.RandomFlip()(sample()),
    "hflip": lambda X: X.RandomHorizontalFlip()(sample()),
    "fixed_resize": lambda X: X.FixedResize((20, 24))(sample(40)),
    "scale": lambda X: X.Scale(16)(sample(40)),
    "center_crop": lambda X: X.CenterCrop(20)(sample(40)),
    "sized_crop": lambda X: X.RandomSizedCrop(24)(sample(40)),
    "rotate": lambda X: X.RandomRotate()(sample(40)),
    "resize_img": lambda X: X.ResizeImg(12)(sample(40)),
    "resize": lambda X: X.Resize(12)(sample(40)),
    "normalize": lambda X: X.Normalize(mean=(0.5, 0.5, 0.5),
                                       std=(0.5, 0.5, 0.5))(sample(8)),
    "normalize_cityscapes": lambda X: X.Normalize_cityscapes(
        mean=(10.0, 10.0, 10.0))(sample(8)),
    "boundary": lambda X: X.GetBoundary(width=2)(boundary_mask()),
    "multilabel": lambda X: X.ToMultiLabel(2),
    "soft_label": lambda X: X.SoftLable([0, 1, 0]),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(EXTRA))
def test_extra_transforms_match_jax(case, seed):
    assert_same(seeded(EXTRA[case], X, seed), seeded(EXTRA[case], jX, seed))


def _img_mask():
    img = np.random.RandomState(0).randint(0, 255, (40, 60, 3),
                                           dtype=np.uint8)
    mask = np.random.RandomState(1).randint(0, 19, (40, 60),
                                            dtype=np.uint8)
    return img, mask


# tests/test_ssda.py and test_aux_components.py's transform calls, each
# from a fresh numpy Generator
TRANSFORMS = {
    "crop_padded": lambda T, g, i, m: T.random_crop(g, i, m, 64),
    "crop": lambda T, g, i, m: T.random_crop(g, i, m, 32),
    "hflip": lambda T, g, i, m: T.random_hflip(g, i, m, p=1.0),
    "scale": lambda T, g, i, m: T.random_scale(g, i, m, (0.5, 2.0)),
    "blur": lambda T, g, i, m: T.random_blur(g, i, p=1.0),
    "cutout": lambda T, g, i, m: T.random_cutout(g, i, m, p=1.0),
    "normalize": lambda T, g, i, m: T.imagenet_normalize(i),
    "pad": lambda T, g, i, m: T.pad_to_min(i, m, 64),
    "resample": lambda T, g, i, m: (T.resample(i, (30, 20)),
                                    T.resample(m, (30, 20), nearest=True)),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_transforms_match_jax(case):
    img, mask = _img_mask()
    outs = [TRANSFORMS[case](mod, np.random.default_rng(5), img, mask)
            for mod in (T, jT)]
    assert_same(*outs)


@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    """tests/test_ssda.py's Cityscapes/GTAV-layout fixture."""
    root = tmp_path_factory.mktemp("dsets")
    rng = np.random.RandomState(0)
    cs = root / "Cityscapes"
    entries = {"train.list": [], "val.list": []}
    (cs / "imgs").mkdir(parents=True)
    (cs / "gt").mkdir(parents=True)
    for lst, n in (("train.list", 4), ("val.list", 2)):
        for k in range(n):
            rel_img = f"imgs/{lst[:-5]}_{k}.png"
            rel_mask = f"gt/{lst[:-5]}_{k}.png"
            Image.fromarray(rng.randint(0, 255, (64, 96, 3), dtype=np.uint8)
                            ).save(cs / rel_img)
            Image.fromarray(rng.randint(0, 19, (64, 96), dtype=np.uint8)
                            ).save(cs / rel_mask)
            entries[lst].append(f"{rel_img} {rel_mask}")
    for lst, lines in entries.items():
        (cs / lst).write_text("\n".join(lines) + "\n")
    g = root / "GTAV"
    (g / "images").mkdir(parents=True)
    (g / "labels").mkdir(parents=True)
    for k in range(2):
        Image.fromarray(rng.randint(0, 255, (48, 80, 3), dtype=np.uint8)
                        ).save(g / "images" / f"g{k}.png")
        raw = rng.choice(list(ID_TO_TRAINID) + [0, 1], (48, 80)
                         ).astype(np.uint8)
        Image.fromarray(raw).save(g / "labels" / f"g{k}.png")
    return str(root)


@pytest.mark.parametrize("mode,labeled", [("labeled", 2), ("unlabeled", 2),
                                          ("test", 0)])
def test_ssda_dataset_matches_jax(city_root, mode, labeled):
    ours = SSDADataset(mode, labeled_num=labeled, root=city_root, size=32)
    theirs = JaxSSDA(mode, labeled_num=labeled, root=city_root, size=32)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        assert_same(ours[i], theirs[i], f"{mode}[{i}]")


def test_dl_utils_numpy_helpers_match_jax():
    lab = np.random.RandomState(0).randint(0, 19, (16, 16))
    assert_same(dl_utils.cityscapes_colormap(), jdl.cityscapes_colormap())
    assert_same(dl_utils.pascal_colormap(), jdl.pascal_colormap())
    for ds in ("cityscapes", "pascal"):
        rgb = dl_utils.decode_segmap(lab, ds)
        assert_same(rgb, jdl.decode_segmap(lab, ds))
        assert_same(dl_utils.encode_segmap(rgb, ds),
                    jdl.encode_segmap(rgb, ds))
    assert dl_utils.lr_poly(0.03, 10, 100, 0.9) == \
        jdl.lr_poly(0.03, 10, 100, 0.9)
    rng = np.random.RandomState(1)
    a, b = rng.randint(0, 3, (2, 16, 16)), rng.randint(0, 3, (2, 16, 16))
    assert dl_utils.get_iou(a, b, 3) == jdl.get_iou(a, b, 3)
    assert dl_utils.get_dice(a == 1, b == 1) == jdl.get_dice(a == 1, b == 1)


def test_post_processing_matches_jax():
    m = np.zeros((32, 32), bool)
    m[2:20, 2:20] = True            # big blob with a hole
    m[5:8, 5:8] = False
    m[28:30, 28:30] = True          # a small component, dropped
    noise = np.random.RandomState(2).rand(32, 32) > 0.8
    for x in (m, noise, np.zeros((8, 8), bool)):
        assert_same(dl_utils.post_processing(x), jdl.post_processing(x))


@pytest.mark.parametrize("kw", [
    {}, {"size_average": False}, {"batch_average": False},
    {"weight": [0.5, 1.0, 2.0, 1.5]}])
def test_cross_entropy2d_matches_jax(kw):
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 6, 5, 4).astype(np.float32)   # NHWC
    target = rng.randint(0, 4, (2, 6, 5)).astype(np.int64)
    target[0, 0, :2] = 255                              # ignored pixels
    ours = float(dl_utils.cross_entropy2d(logits, target, **kw))
    theirs = float(jdl.cross_entropy2d(logits, target, **kw))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)


def _logits(seed, shape=(2, 8, 8, 3)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (port call, JAX call) on the same numpy inputs
LOSSES = {
    "dice_plain": lambda F, t: F.dice_loss_plain(
        t(np.random.RandomState(0).rand(2, 8, 8)),
        t((np.random.RandomState(1).rand(2, 8, 8) > 0.5).astype(np.float32))),
    "focal": lambda F, t: F.focal_loss(
        t(_logits(0)), t(np.random.RandomState(1).randint(0, 3, (2, 8, 8)))),
    "focal_sum": lambda F, t: F.focal_loss(
        t(_logits(0)), t(np.random.RandomState(1).randint(0, 3, (2, 8, 8))),
        gamma=1.5, size_average=False),
    "focal_alpha": lambda F, t: F.focal_loss(
        t(_logits(2, (2, 8, 8, 2))),
        t(np.random.RandomState(3).randint(0, 2, (2, 8, 8))), alpha=0.25),
    "focal_alpha_list": lambda F, t: F.focal_loss(
        t(_logits(0)), t(np.random.RandomState(1).randint(0, 3, (2, 8, 8))),
        alpha=[0.2, 0.3, 0.5]),
    "softmax_dice": lambda F, t: F.softmax_dice_loss(t(_logits(1)),
                                                     t(_logits(2))),
    "softmax_mse": lambda F, t: F.softmax_mse_loss(t(_logits(1)),
                                                   t(_logits(2))),
    "sigmoid_mse": lambda F, t: F.softmax_mse_loss(t(_logits(1)),
                                                   t(_logits(2)),
                                                   sigmoid=True),
    "softmax_kl": lambda F, t: F.softmax_kl_loss(t(_logits(1)),
                                                 t(_logits(2))),
    "sigmoid_kl": lambda F, t: F.softmax_kl_loss(t(_logits(1)),
                                                 t(_logits(2)), sigmoid=True),
    "entropy": lambda F, t: F.entropy_loss(
        t(np.random.RandomState(4).dirichlet((1, 1, 1), (2, 8, 8))
          .astype(np.float32)), n_classes=3),
    "entropy_map": lambda F, t: F.entropy_map(
        t(np.random.RandomState(4).dirichlet((1, 1), (2, 8, 8))
          .astype(np.float32))),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_aux_losses_match_jax(case):
    ours = LOSSES[case](L, torch.from_numpy)
    theirs = LOSSES[case](jL, jnp.asarray)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL,
                               atol=ATOL)


def test_numpy_dice_matches_jax():
    rng = np.random.RandomState(0)
    b, bt = rng.rand(3, 16, 16) > 0.5, rng.rand(3, 16, 16) > 0.3
    two, twot = rng.rand(3, 2, 16, 16) > 0.5, rng.rand(3, 2, 16, 16) > 0.5
    c, ct = rng.randint(0, 4, (3, 16, 16)), rng.randint(0, 4, (3, 16, 16))
    z = np.zeros((4, 4))
    assert M.dice_coefficient_np(z, z) == jM.dice_coefficient_np(z, z) == 0
    for name, x, y in (("dice_coeff_np", b, bt),
                       ("dice_coeff_2label_np", two, twot),
                       ("dice_coeff_3label_np", c, ct)):
        for args in ((x, y), (x[0], y[0]), (x, y, True)):
            assert_same(getattr(M, name)(*args), getattr(jM, name)(*args),
                        f"{name}{len(args)}")


@pytest.mark.parametrize("n_part", [1, 2, 3])
def test_per_label_dice_matches_jax(n_part):
    rng = np.random.RandomState(n_part)
    if n_part == 2:
        pred, gt = rng.rand(4, 16, 16, 2) > 0.5, rng.rand(4, 16, 16, 2) > 0.5
    elif n_part == 3:
        pred, gt = rng.randint(0, 4, (4, 16, 16)), rng.randint(0, 4,
                                                               (4, 16, 16))
    else:
        pred, gt = rng.rand(4, 16, 16) > 0.5, rng.rand(4, 16, 16) > 0.3
        pred[0], gt[0] = False, False            # empty-empty reads 0
    fn = {1: "dice_coeff", 2: "dice_coeff_2label", 3: "dice_coeff_3label"}
    ours = getattr(M, fn[n_part])(torch.from_numpy(pred),
                                  torch.from_numpy(gt))
    theirs = getattr(jM, fn[n_part] + "_jax")(pred, gt)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        M.dice_per_part(torch.from_numpy(pred), torch.from_numpy(gt),
                        n_part).numpy(), ours.numpy())


def test_ramps_match_jax():
    for cur, length in ((0, 10), (5, 10), (20, 10), (3, 0), (7.5, 10)):
        assert R.linear_rampup(cur, length) == jR.linear_rampup(cur, length)
    for cur in (0, 2.5, 5, 10, 13):
        assert R.cosine_rampdown(cur, 10) == jR.cosine_rampdown(cur, 10)
    with pytest.raises(ValueError):
        R.linear_rampup(1, -1)
