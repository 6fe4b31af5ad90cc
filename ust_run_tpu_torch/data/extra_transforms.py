"""The reference's unused augmentation surface, rebuilt host-side (the
port's copy of ust_run_tpu/data/extra_transforms.py).

dataloaders/custom_transforms.py ships many transform classes that no
entry point reaches; the *used* chain lives on-device in ops/augment.py.
These are the remaining classes, completing the C6 component inventory
(SURVEY section 2): salt-pepper noise (:25), gamma adjust_light (:48),
reverse_aug (:120), eraser (:168), cutout (:258), the
RandomFlip/Rotate/Sized/Fixed/Scale/Resize family (:347-586), Normalize
(:608), GetBoundary (:630), Normalize_cityscapes (:687), ToMultiLabel /
SoftLable (:705-724).

Same sample-dict calling convention ({'image','label','img_name',...})
and same distributions/probabilities; internals are numpy-first (the
gamma LUT, flips, erasing and the separable reflect-padded gaussian are
array ops — no cv2/torch dependency).
"""

import math
import random

import numpy as np
from PIL import Image
from scipy import ndimage


def _rand():
    return random.random()


class add_salt_pepper_noise:
    """custom_transforms.py:25-46: 0.4% of pixels to 1 (salt, p=.25) or
    0 (pepper, p=.25); note the reference writes value 1, not 255."""

    def __call__(self, sample):
        img = np.asarray(sample["image"]).copy()
        amount, salt_frac = 0.004, 0.2
        seed = _rand()
        if seed > 0.5:
            value = 1 if seed > 0.75 else 0
            frac = salt_frac if seed > 0.75 else 1.0 - salt_frac
            count = int(np.ceil(amount * img.size * frac))
            ys = np.random.randint(0, img.shape[0] - 1, count)
            xs = np.random.randint(0, img.shape[1] - 1, count)
            img[ys, xs, :] = value
        sample["image"] = img
        return sample


class adjust_light:
    """custom_transforms.py:48-58: p=0.5 gamma in [0.5, 3.5] via LUT."""

    def __call__(self, sample):
        if _rand() > 0.5:
            gamma = _rand() * 3 + 0.5
            lut = ((np.arange(256) / 255.0) ** (1.0 / gamma) * 255
                   ).astype(np.uint8)
            img = lut[np.asarray(sample["image"], np.uint8)]
            sample["image"] = img
        return sample


def _separable_gaussian_reflect(x, radius, sigma):
    """Float HWC separable gaussian with mirror (ReflectionPad2d)
    boundary, the reference's conv pipeline (custom_transforms.py:84-117)."""
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-t * t / (2 * sigma * sigma))
    k /= k.sum()
    out = ndimage.convolve1d(x, k, axis=0, mode="mirror")
    return ndimage.convolve1d(out, k, axis=1, mode="mirror")


class reverse_aug:
    """custom_transforms.py:120-166: anti-correlated brightness/contrast
    on an image pair (v and 2-v), then gaussian-blur the first."""

    def __init__(self, kernel_size, num_channels, min_v, max_v):
        self.r = kernel_size // 2
        self.min_v = min_v
        self.max_v = max_v
        del num_channels  # channel count follows the input

    @staticmethod
    def _enhance(img, brightness, contrast):
        x = np.asarray(img, np.float64)
        x = x * brightness                       # ImageEnhance.Brightness
        gray = np.asarray(
            Image.fromarray(np.clip(x, 0, 255).astype(np.uint8))
            .convert("L"), np.float64).mean()    # ImageEnhance.Contrast
        x = gray + (x - gray) * contrast
        return np.clip(x, 0, 255).astype(np.uint8)

    def __call__(self, img1, img2):
        img1, img2 = np.asarray(img1), np.asarray(img2)
        v = self.min_v + (self.max_v - self.min_v) * _rand()
        img1 = self._enhance(img1, v, 1.0)
        img2 = self._enhance(img2, 2 - v, 1.0)
        v = self.min_v + (self.max_v - self.min_v) * _rand()
        img1 = self._enhance(img1, 1.0, v)
        img2 = self._enhance(img2, 1.0, 2 - v)
        sigma = np.random.uniform(0.1, 2.0)
        blurred = _separable_gaussian_reflect(img1 / 255.0, self.r, sigma)
        img1 = np.clip(blurred * 255, 0, 255).astype(np.uint8)
        return Image.fromarray(img1), Image.fromarray(img2)


def _reject_sample_box(img_h, img_w, area_range, aspect_range):
    while True:
        s = np.random.uniform(*area_range) * img_h * img_w
        r = np.random.uniform(*aspect_range)
        w = int(np.sqrt(s / r))
        h = int(np.sqrt(s * r))
        left = np.random.randint(0, img_w)
        top = np.random.randint(0, img_h)
        if left + w <= img_w and top + h <= img_h:
            return top, left, h, w


class eraser:
    """custom_transforms.py:168-196: p=0.5 constant-fill erasing, image
    only (the label is untouched)."""

    def __call__(self, sample, s_l=0.02, s_h=0.06, r_1=0.3, r_2=0.6,
                 v_l=0, v_h=255, pixel_level=False):
        if _rand() > 0.5:
            return sample
        img = np.asarray(sample["image"]).copy()
        top, left, h, w = _reject_sample_box(
            img.shape[0], img.shape[1], (s_l, s_h), (r_1, r_2))
        if pixel_level:
            fill = np.random.uniform(v_l, v_h, (h, w, img.shape[2]))
        else:
            fill = np.random.uniform(v_l, v_h)
        img[top:top + h, left:left + w, :] = fill
        sample["image"] = img
        return sample


class cutout:
    """custom_transforms.py:258-305: p=0.5 pixel-level erasing; the
    erased label region becomes 255."""

    def __call__(self, sample):
        if _rand() >= 0.5:
            return sample
        img = np.asarray(sample["image"]).copy()
        mask = np.asarray(sample["label"]).copy()
        top, left, h, w = _reject_sample_box(
            img.shape[0], img.shape[1], (0.02, 0.4), (0.3, 1 / 0.3))
        shape = (h, w) + ((img.shape[2],) if img.ndim == 3 else ())
        img[top:top + h, left:left + w] = np.random.uniform(0, 255, shape)
        mask[top:top + h, left:left + w] = 255
        sample["image"] = Image.fromarray(img.astype(np.uint8))
        sample["label"] = mask
        return sample


class RandomFlip:
    """custom_transforms.py:372-385: independent p=0.5 H and V flips."""

    def __call__(self, sample):
        img = np.asarray(sample["image"])
        mask = np.asarray(sample["label"])
        if _rand() < 0.5:
            img, mask = img[:, ::-1], mask[:, ::-1]
        if _rand() < 0.5:
            img, mask = img[::-1], mask[::-1]
        sample["image"] = Image.fromarray(np.ascontiguousarray(img))
        sample["label"] = Image.fromarray(np.ascontiguousarray(mask))
        return sample


class RandomHorizontalFlip:
    """custom_transforms.py:387-397 (the PIL variant; the used chain's
    on-device flip lives in ops/augment.py)."""

    def __call__(self, sample):
        if _rand() < 0.5:
            sample["image"] = sample["image"].transpose(
                Image.FLIP_LEFT_RIGHT)
            sample["label"] = sample["label"].transpose(
                Image.FLIP_LEFT_RIGHT)
        return sample


class FixedResize:
    """custom_transforms.py:400-417: (h, w) target."""

    def __init__(self, size):
        self.size = tuple(reversed(size))

    def __call__(self, sample):
        sample["image"] = sample["image"].resize(self.size, Image.BILINEAR)
        sample["label"] = sample["label"].resize(self.size, Image.NEAREST)
        return sample


class Scale:
    """custom_transforms.py:420-443: resize unless one side already
    matches."""

    def __init__(self, size):
        self.size = (int(size), int(size)) if np.isscalar(size) else size

    def __call__(self, sample):
        img, mask = sample["image"], sample["label"]
        w, h = img.size
        if (w >= h and w == self.size[1]) or (h >= w and h == self.size[0]):
            return sample
        oh, ow = self.size
        sample["image"] = img.resize((ow, oh), Image.BILINEAR)
        sample["label"] = mask.resize((ow, oh), Image.NEAREST)
        return sample


class CenterCrop:
    """custom_transforms.py:347-369."""

    def __init__(self, size):
        self.size = (int(size), int(size)) if np.isscalar(size) else size

    def __call__(self, sample):
        img, mask = sample["image"], sample["label"]
        w, h = img.size
        th, tw = self.size
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        sample["image"] = img.crop((x1, y1, x1 + tw, y1 + th))
        sample["label"] = mask.crop((x1, y1, x1 + tw, y1 + th))
        return sample


class RandomSizedCrop:
    """custom_transforms.py:445-485: 10 rejection attempts for an
    area/aspect crop, else Scale+CenterCrop fallback."""

    def __init__(self, size):
        self.size = size

    def __call__(self, sample):
        img, mask = sample["image"], sample["label"]
        for _ in range(10):
            area = img.size[0] * img.size[1]
            target = random.uniform(0.45, 1.0) * area
            aspect = random.uniform(0.5, 2)
            w = int(round(math.sqrt(target * aspect)))
            h = int(round(math.sqrt(target / aspect)))
            if _rand() < 0.5:
                w, h = h, w
            if w <= img.size[0] and h <= img.size[1]:
                x1 = random.randint(0, img.size[0] - w)
                y1 = random.randint(0, img.size[1] - h)
                img = img.crop((x1, y1, x1 + w, y1 + h))
                mask = mask.crop((x1, y1, x1 + w, y1 + h))
                sample["image"] = img.resize((self.size, self.size),
                                             Image.BILINEAR)
                sample["label"] = mask.resize((self.size, self.size),
                                              Image.NEAREST)
                return sample
        return CenterCrop(self.size)(Scale(self.size)(sample))


class RandomRotate:
    """custom_transforms.py:488-504: one fixed multiple of 90 degrees
    drawn at CONSTRUCTION time, applied with p=0.5 per call."""

    def __init__(self, size=512):
        self.degree = random.randint(1, 4) * 90
        self.size = size

    def __call__(self, sample):
        if _rand() > 0.5:
            sample["image"] = sample["image"].rotate(
                self.degree, Image.BILINEAR, expand=0)
            sample["label"] = sample["label"].rotate(
                self.degree, Image.NEAREST, expand=255)
        return sample


class ResizeImg:
    """custom_transforms.py:551-565: resizes the image ONLY."""

    def __init__(self, size):
        self.size = size

    def __call__(self, sample):
        sample["image"] = sample["image"].resize((self.size, self.size))
        return sample


class Resize:
    """custom_transforms.py:568-582."""

    def __init__(self, size):
        self.size = size

    def __call__(self, sample):
        sample["image"] = sample["image"].resize((self.size, self.size))
        sample["label"] = sample["label"].resize((self.size, self.size))
        return sample


class Normalize:
    """custom_transforms.py:608-627: /255 then mean/std."""

    def __init__(self, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)):
        self.mean = mean
        self.std = std

    def __call__(self, sample):
        img = np.asarray(sample["image"], np.float32) / 255.0
        img = (img - self.mean) / self.std
        return {"image": img,
                "label": np.asarray(sample["label"], np.float32),
                "img_name": sample["img_name"]}


class Normalize_cityscapes:
    """custom_transforms.py:687-703: mean-subtract BEFORE /255."""

    def __init__(self, mean=(0.0, 0.0, 0.0)):
        self.mean = mean

    def __call__(self, sample):
        img = (np.asarray(sample["image"], np.float32) - self.mean) / 255.0
        return {"image": img,
                "label": np.asarray(sample["label"], np.float32),
                "img_name": sample["img_name"]}


class GetBoundary:
    """custom_transforms.py:630-648: band of width 2w around each of the
    cup/disc contours, via dilation+erosion difference."""

    def __init__(self, width=5):
        self.width = width

    def __call__(self, mask):
        out = np.zeros(mask.shape[:2], bool)
        for c in range(2):
            plane = mask[:, :, c]
            dila = ndimage.binary_dilation(plane, iterations=self.width)
            eros = ndimage.binary_erosion(plane, iterations=self.width)
            band = dila.astype(np.int32) + eros.astype(np.int32)
            out |= band == 1             # in dilation but not erosion
        return out.astype(np.uint8)


def ToMultiLabel(dc):
    """custom_transforms.py:705-710: one-hot over 3 slots.

    Deliberate delta: the reference returns None for dc outside 0..2
    (falls off the if-chain); this returns the zero vector so callers
    get a fixed-shape array. No in-repo caller passes out-of-range dc.
    """
    out = np.zeros([3])
    if 0 <= dc < 3:
        out[dc] = 1
    return out


def SoftLable(label):
    """custom_transforms.py:713-725: soften a one-hot vector — the hot
    entry gets 0.8..1.0, the remainder is randomly split with the last
    slot absorbing the residual."""
    new = np.array(label, dtype=float)
    index = int(np.argmax(label))
    new[index] = 0.8 + random.random() * 0.2
    used = new[index]
    n = len(new)
    for i in range(n):
        if i == index:
            continue
        if i == n - 1:
            new[i] = 1 - used
        else:
            new[i] = random.random() * (1 - used)
            used += new[i]
    return new
