"""Cityscapes/GTAV semi-supervised domain adaptation dataset (the port's
copy of ust_run_tpu/data/ssda.py).

Capability parity with the reference's vestigial `SSDADataset`
(dataloaders/dataloader.py:473-539; constructed nowhere in the reference
but part of its surface): labeled = first `labeled_num` Cityscapes train
images + all GTAV images; unlabeled = remaining Cityscapes train images;
test = Cityscapes val list. GTAV label ids are remapped to the 19
Cityscapes train ids; unlabeled samples get a strong view (color jitter /
grayscale / blur). Built on the array-native transform library with an
explicit per-dataset RNG. Exercised by tests/test_ssda.py against a
synthetic Cityscapes/GTAV-layout fixture.
"""

import os
from glob import glob

import numpy as np
from PIL import Image

from ust_run_tpu_torch.data import transform as T

ID_TO_TRAINID = {7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7,
                 21: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14,
                 28: 15, 31: 16, 32: 17, 33: 18}


def _remap_gtav_ids(mask):
    """GTAV raw ids -> the 19 Cityscapes train ids, rest ignored."""
    lut = np.full(256, T.IGNORE_ID, np.float32)
    for k, v in ID_TO_TRAINID.items():
        lut[k] = v
    return lut[mask.astype(np.uint8)]


def _color_jitter(rng, img):
    """HWC uint8 color jitter (brightness/contrast/saturation/hue) with
    the torchvision ColorJitter(0.5, 0.5, 0.5, 0.25) ranges
    (dataloader.py:534)."""
    x = img.astype(np.float32)
    x = x * (1 + rng.uniform(-0.5, 0.5))                    # brightness
    x = (x - x.mean()) * (1 + rng.uniform(-0.5, 0.5)) + x.mean()  # contrast
    gray = x.mean(axis=2, keepdims=True)
    x = gray + (x - gray) * (1 + rng.uniform(-0.5, 0.5))    # saturation
    x = np.clip(x, 0, 255).astype(np.uint8)
    hue = rng.uniform(-0.25, 0.25)
    if abs(hue) > 1e-3:
        hsv = np.asarray(Image.fromarray(x).convert("HSV"), np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(hue * 255)) % 256
        x = np.asarray(Image.fromarray(hsv.astype(np.uint8),
                                       "HSV").convert("RGB"))
    return x


class SSDADataset:
    def __init__(self, mode, labeled_num, root="/data/DataSets/", size=512,
                 seed=0):
        self.root = root
        self.mode = mode
        self.size = size
        self.rng = np.random.default_rng(seed)
        if mode == "labeled":
            self.path = self._read_list("Cityscapes/train.list")[:labeled_num]
            self.path += sorted(glob(os.path.join(root, "GTAV/images/*.png")))
        elif mode == "unlabeled":
            self.path = self._read_list("Cityscapes/train.list")[labeled_num:]
        elif mode == "test":
            self.path = self._read_list("Cityscapes/val.list")
        else:
            raise ValueError(mode)

    def _read_list(self, rel):
        with open(os.path.join(self.root, rel)) as f:
            return f.read().splitlines()

    def __len__(self):
        return len(self.path)

    def _load(self, entry):
        """Decode one (image, raw mask) pair as HWC/HW uint8 arrays."""
        if "GTAV" in entry:
            img_p = entry
            mask_p = entry.replace("images", "labels")
        else:
            rel_img, rel_mask = entry.split(" ")
            img_p = os.path.join(self.root, "Cityscapes", rel_img)
            mask_p = os.path.join(self.root, "Cityscapes", rel_mask)
        img = np.asarray(Image.open(img_p).convert("RGB"))
        mask = np.asarray(Image.open(mask_p))
        return img, mask

    def __getitem__(self, item):
        entry = self.path[item]
        s = self.size
        img, mask = self._load(entry)
        img = T.resample(img, (s, s))
        mask = T.resample(mask, (s, s), nearest=True)
        if self.mode == "test":
            return (T.imagenet_normalize(img), mask.astype(np.int64),
                    entry)

        rng = self.rng
        img, mask = T.random_scale(rng, img, mask, (0.5, 2.0))
        img, mask = T.random_crop(rng, img, mask, s)
        img, mask = T.random_hflip(rng, img, mask, p=0.5)
        strong = img
        if "GTAV" in entry:
            mask = _remap_gtav_ids(mask)
        if self.mode == "labeled":
            return (T.imagenet_normalize(img), np.asarray(mask, np.int64),
                    entry)
        # unlabeled: weak view + strong view (dataloader.py:530-537)
        if rng.random() < 0.8:
            strong = _color_jitter(rng, strong)
        if rng.random() < 0.2:
            strong = np.repeat(strong.mean(axis=2, keepdims=True),
                               3, axis=2).astype(np.uint8)
        strong = T.random_blur(rng, strong, p=0.5)
        return (T.imagenet_normalize(img), T.imagenet_normalize(strong),
                np.asarray(mask, np.int64), entry)
