"""Dataset manifests and the host-side decode cache.

Capability parity with reference dataloaders/dataloader.py (four Dataset
classes, :13-444). The reference re-decodes and re-augments every image
with PIL inside DataLoader worker processes on every epoch; here each
image is decoded ONCE at startup into a pinned uint8 numpy cache (the
datasets are a few hundred images of <=384^2 — tens of MB), and all
augmentation runs on-device (ops/augment.py). This removes the reference's
host-side bottleneck entirely.

Split semantics preserved exactly:
  * selected_idxs apply ONLY to the `splitid` domain; all other requested
    domains contribute every image (dataloader.py:67-75);
  * labeled set = first `lb_num` indices of the labeled domain; unlabeled
    = the rest of that domain + all of the other domains (train.py:478-485);
  * BUSI pairs image files with their `*_mask*` siblings, merges multiple
    masks by elementwise max, and takes the LAST 20% of each domain as
    test (dataloader.py:380-404);
  * fundus train lists come from `Domain{i}_train.txt`, test from a sorted
    glob of `Domain{i}/test/ROIs/image/*.png` (dataloader.py:58-64).
"""

import dataclasses
import os
from glob import glob
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image

from ust_run_tpu_torch.config import DatasetProfile

DOMAIN_NAMES = {
    "fundus": {1: "DGS", 2: "RIM", 3: "REF", 4: "REF_val"},
    "prostate": {1: "BIDMC", 2: "BMC", 3: "HK", 4: "I2CVB", 5: "RUNMC",
                 6: "UCL"},
    "MNMS": {1: "vendorA", 2: "vendorB", 3: "vendorC", 4: "vendorD"},
    "BUSI": {1: "benign", 2: "malignant"},
}


@dataclasses.dataclass
class SampleRef:
    image_path: str
    mask_paths: List[str]  # >1 only for BUSI multi-mask samples
    img_name: str
    domain_code: int


def _apply_selection(items, domain, splitid, selected_idxs):
    """Keep only selected_idxs for the splitid domain (dataloader.py:67-75)."""
    if splitid == domain and selected_idxs is not None:
        keep = set(selected_idxs)
        return [x for i, x in enumerate(items) if i in keep]
    return items


def build_manifest(dataset: str, base_dir: str, phase: str,
                   splitid: int, domains: Sequence[int],
                   selected_idxs: Optional[Sequence[int]] = None
                   ) -> List[SampleRef]:
    names = DOMAIN_NAMES[dataset]
    refs: List[SampleRef] = []
    for i in domains:
        if dataset == "fundus":
            img_dir = os.path.join(base_dir, f"Domain{i}", phase,
                                   "ROIs/image/")
            if phase == "train":
                with open(os.path.join(base_dir, f"Domain{i}_train.txt")) as f:
                    imagelist = [ln.strip() for ln in f if ln.strip()]
            else:
                imagelist = sorted(glob(img_dir + "*.png"))
            imagelist = _apply_selection(imagelist, i, splitid, selected_idxs)
            for p in imagelist:
                refs.append(SampleRef(p, [p.replace("image", "mask")],
                                      os.path.basename(p), i))
        elif dataset in ("prostate", "MNMS"):
            img_dir = os.path.join(base_dir, names[i], phase, "image/")
            imagelist = sorted(glob(img_dir + "*.png"))
            imagelist = _apply_selection(imagelist, i, splitid, selected_idxs)
            for p in imagelist:
                refs.append(SampleRef(p, [p.replace("image", "mask")],
                                      names[i] + "_" + os.path.basename(p), i))
        elif dataset == "BUSI":
            img_dir = os.path.join(base_dir, names[i] + "/")
            files = sorted(glob(img_dir + "*.png"))
            groups: List[List[str]] = []
            for p in files:
                if "mask" not in p:
                    groups.append([p])
                else:
                    groups[-1].append(p)
            test_num = int(len(groups) * 0.2)
            if phase == "test":
                groups = groups[-test_num:]
            elif phase == "train":
                groups = groups[:len(groups) - test_num]
            groups = _apply_selection(groups, i, splitid, selected_idxs)
            for g in groups:
                refs.append(SampleRef(g[0], g[1:],
                                      names[i] + "_" + os.path.basename(g[0]),
                                      i))
        else:
            raise ValueError(dataset)
    return refs


def _decode(dataset: str, ref: SampleRef, profile: DatasetProfile):
    """PIL decode + resize, reproducing each dataset's __getitem__ head
    (dataloader.py:95-101, 222-231, 326-332, 417-433). Sizes come from the
    profile (256 fundus/BUSI, 288 MNMS, native for prostate) so the
    --patch_override smoke-test extension works uniformly."""
    ls = profile.load_size
    if dataset == "fundus":
        img = Image.open(ref.image_path).convert("RGB").resize(
            (ls, ls), Image.LANCZOS)
        tgt = Image.open(ref.mask_paths[0])
        if tgt.mode == "RGB":
            tgt = tgt.convert("L")
        tgt = tgt.resize((ls, ls), Image.NEAREST)
        img_np = np.asarray(img, np.uint8)
        tgt_np = np.asarray(tgt, np.uint8)[..., None]
    elif dataset == "prostate":
        img = Image.open(ref.image_path)
        tgt = Image.open(ref.mask_paths[0])
        if img.mode == "RGB":
            img = img.convert("L")
        if tgt.mode == "RGB":
            tgt = tgt.convert("L")
        img_np = np.asarray(img, np.uint8)[..., None]
        tgt_np = np.asarray(tgt, np.uint8)[..., None]
    elif dataset == "MNMS":
        img = Image.open(ref.image_path).resize((ls, ls), Image.BILINEAR)
        tgt = Image.open(ref.mask_paths[0]).resize((ls, ls), Image.NEAREST)
        if img.mode == "RGB":
            img = img.convert("L")
        img_np = np.asarray(img, np.uint8)
        if img_np.ndim == 2:
            img_np = img_np[..., None]
        tgt_np = np.asarray(tgt, np.uint8)
        if tgt_np.ndim == 2:  # tolerate single-channel synthetic fixtures
            tgt_np = np.stack([tgt_np] * 3, axis=-1)
        tgt_np = tgt_np[..., :3]
    elif dataset == "BUSI":
        img = Image.open(ref.image_path).convert("L").resize(
            (ls, ls), Image.LANCZOS)
        img_np = np.asarray(img, np.uint8)[..., None]
        if len(ref.mask_paths) == 1:
            tgt = Image.open(ref.mask_paths[0]).convert("L").resize(
                (ls, ls), Image.NEAREST)
        else:
            merged = None
            for mp in ref.mask_paths:
                m = np.asarray(Image.open(mp).convert("L"), np.uint8)
                merged = m if merged is None else np.maximum(merged, m)
            tgt = Image.fromarray(merged).convert("L").resize(
                (ls, ls), Image.NEAREST)
        tgt_np = np.asarray(tgt, np.uint8)[..., None]
    else:
        raise ValueError(dataset)
    return img_np, tgt_np


class SegmentationDataset:
    """In-RAM decoded dataset. Arrays:
        images: (N, S, S, C) uint8
        labels: (N, S, S, K) uint8  (K=3 for MNMS one-hot-by-255 masks)
        dc:     (N,) int32 1-based domain codes
        names:  list of img_name strings
    """

    def __init__(self, dataset: str, profile: DatasetProfile, base_dir: str,
                 phase: str, splitid: int, domains: Sequence[int],
                 selected_idxs: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.profile = profile
        self.phase = phase
        refs = build_manifest(dataset, base_dir, phase, splitid, domains,
                              selected_idxs)
        if not refs:
            raise ValueError(
                f"no samples for {dataset} phase={phase} domains={domains} "
                f"under {base_dir}")
        imgs, tgts, dcs, names = [], [], [], []
        for r in refs:
            i, t = _decode(dataset, r, profile)
            imgs.append(i)
            tgts.append(t)
            dcs.append(r.domain_code)
            names.append(r.img_name)
        self.images = np.stack(imgs)
        self.labels = np.stack(tgts)
        self.dc = np.asarray(dcs, np.int32)
        self.names = names

    def __len__(self):
        return len(self.names)
