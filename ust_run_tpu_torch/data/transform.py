"""Array-native functional transforms for the SSDA (Cityscapes/GTAV)
path (the port's copy of ust_run_tpu/data/transform.py).

Same capabilities as the reference's PIL-object helpers
(dataloaders/transform.py:8-102 — crop/hflip/normalize/resize/blur/
cutout) but a different design: every function takes and returns numpy
HWC uint8 arrays and draws randomness from an explicit
`numpy.random.Generator` (no hidden global RNG, trivially seedable and
thread-safe for loader workers). PIL is used only as a resampling kernel
(BILINEAR for images, NEAREST for label maps).
"""

import numpy as np
from PIL import Image, ImageFilter

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
IGNORE_ID = 255


def resample(img, size_wh, *, nearest=False):
    """Resize an HWC/HW uint8 array via PIL kernels."""
    mode = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(Image.fromarray(img).resize(size_wh, mode))


def pad_to_min(img, mask, size):
    """Bottom/right-pad so both sides reach `size`; image pads with 0,
    label map pads with the ignore id."""
    h, w = img.shape[:2]
    ph, pw = max(0, size - h), max(0, size - w)
    if ph == 0 and pw == 0:
        return img, mask
    img_pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
    img = np.pad(img, img_pad, constant_values=0)
    mask = np.pad(mask, [(0, ph), (0, pw)], constant_values=IGNORE_ID)
    return img, mask


def random_crop(rng, img, mask, size):
    """Uniform random `size`x`size` window (pads first if needed)."""
    img, mask = pad_to_min(img, mask, size)
    h, w = img.shape[:2]
    y = int(rng.integers(0, h - size + 1))
    x = int(rng.integers(0, w - size + 1))
    return (img[y:y + size, x:x + size],
            mask[y:y + size, x:x + size])


def random_hflip(rng, img, mask, p=0.5):
    if rng.random() < p:
        return img[:, ::-1], mask[:, ::-1]
    return img, mask


def random_scale(rng, img, mask, ratio_range):
    """Rescale so the long side lands uniformly in
    [long*lo, long*hi], aspect preserved."""
    h, w = img.shape[:2]
    long_side = max(h, w)
    target = int(rng.integers(int(long_side * ratio_range[0]),
                              int(long_side * ratio_range[1]) + 1))
    scale = target / long_side
    ow, oh = (target, int(h * scale + 0.5)) if w >= h else \
        (int(w * scale + 0.5), target)
    return (resample(img, (ow, oh)),
            resample(mask, (ow, oh), nearest=True))


def random_blur(rng, img, p=0.5, sigma_range=(0.1, 2.0)):
    if rng.random() < p:
        sigma = float(rng.uniform(*sigma_range))
        return np.asarray(Image.fromarray(img).filter(
            ImageFilter.GaussianBlur(radius=sigma)))
    return img


def random_cutout(rng, img, mask, p=0.5, area=(0.02, 0.4),
                  aspect=(0.3, 1 / 0.3), fill=(0, 255), pixel_level=True):
    """Random erasing; the erased label region becomes the ignore id."""
    if rng.random() >= p:
        return img, mask
    h, w = img.shape[:2]
    while True:
        a = float(rng.uniform(*area)) * h * w
        r = float(rng.uniform(*aspect))
        ew, eh = int(np.sqrt(a / r)), int(np.sqrt(a * r))
        x = int(rng.integers(0, w))
        y = int(rng.integers(0, h))
        if x + ew <= w and y + eh <= h:
            break
    img = img.copy()
    mask = mask.copy()
    shape = (eh, ew) + img.shape[2:] if pixel_level else ()
    img[y:y + eh, x:x + ew] = rng.uniform(fill[0], fill[1],
                                          shape).astype(img.dtype)
    mask[y:y + eh, x:x + ew] = IGNORE_ID
    return img, mask


def imagenet_normalize(img):
    """uint8 HWC -> float32 CHW, ImageNet statistics."""
    x = np.asarray(img, np.float32) / 255.0
    if x.ndim == 3:
        x = (x - IMAGENET_MEAN) / IMAGENET_STD
        x = np.transpose(x, (2, 0, 1))
    return x
