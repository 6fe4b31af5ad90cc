"""Synthetic dataset generator.

Writes a miniature on-disk dataset in the exact directory layout each
reference Dataset class expects (dataloaders/dataloader.py:13-444), so the
full train/eval/test CLI path can run without the real medical data —
playing the role of the tiny sample images checked into the reference's
`data/` directory (SURVEY.md section 4).

Images contain a random blob; masks follow each dataset's label encoding:
  fundus:   0 = cup, 128 = disc ring, 255 = background
  prostate: 0 = foreground, 255 = background
  BUSI:     255 = foreground, 0 = background
  MNMS:     3-channel one-hot-by-255 for classes 1..3
"""

import argparse
import os

import numpy as np
from PIL import Image

from ust_run_tpu_torch.data.datasets import DOMAIN_NAMES


def _blob(rng, size, r_lo=0.1, r_hi=0.3):
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = rng.randint(size // 4, 3 * size // 4, 2)
    r = rng.uniform(r_lo, r_hi) * size
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r, (cy, cx, r)


def _make_pair(rng, dataset, size):
    img = rng.randint(30, 220, (size, size), np.uint8)
    blob, (cy, cx, r) = _blob(rng, size)
    img = np.where(blob, np.clip(img + 30, 0, 255), img).astype(np.uint8)
    if dataset == "fundus":
        mask = np.full((size, size), 255, np.uint8)
        mask[blob] = 128
        inner = (np.mgrid[0:size, 0:size][0] - cy) ** 2 \
            + (np.mgrid[0:size, 0:size][1] - cx) ** 2 <= (0.5 * r) ** 2
        mask[inner] = 0
        img3 = np.stack([img] * 3, axis=-1)
        return Image.fromarray(img3), Image.fromarray(mask)
    if dataset == "prostate":
        mask = np.full((size, size), 255, np.uint8)
        mask[blob] = 0
        return Image.fromarray(img), Image.fromarray(mask)
    if dataset == "BUSI":
        mask = np.zeros((size, size), np.uint8)
        mask[blob] = 255
        return Image.fromarray(img), Image.fromarray(mask)
    if dataset == "MNMS":
        mask = np.zeros((size, size, 3), np.uint8)
        grid = np.mgrid[0:size, 0:size]
        d2 = (grid[0] - cy) ** 2 + (grid[1] - cx) ** 2
        mask[d2 <= (0.4 * r) ** 2, 0] = 255                      # class 1
        mask[(d2 > (0.4 * r) ** 2) & (d2 <= (0.7 * r) ** 2), 1] = 255
        mask[(d2 > (0.7 * r) ** 2) & (d2 <= r ** 2), 2] = 255    # class 3
        return Image.fromarray(img), Image.fromarray(mask)
    raise ValueError(dataset)


def generate(dataset, root, n_train=8, n_test=3, size=None, seed=0):
    """Create the dataset tree under `root`. Returns root."""
    default_size = {"fundus": 256, "prostate": 384, "BUSI": 256, "MNMS": 288}
    size = size or default_size[dataset]
    rng = np.random.RandomState(seed)
    names = DOMAIN_NAMES[dataset]
    for i, dom in names.items():
        if dataset == "fundus":
            train_list = []
            for phase, n in (("train", n_train), ("test", n_test)):
                img_dir = os.path.join(root, f"Domain{i}", phase,
                                       "ROIs", "image")
                msk_dir = os.path.join(root, f"Domain{i}", phase,
                                       "ROIs", "mask")
                os.makedirs(img_dir, exist_ok=True)
                os.makedirs(msk_dir, exist_ok=True)
                for k in range(n):
                    img, msk = _make_pair(rng, dataset, size)
                    name = f"d{i}_{phase}_{k:03d}.png"
                    img.save(os.path.join(img_dir, name))
                    msk.save(os.path.join(msk_dir, name))
                    if phase == "train":
                        train_list.append(os.path.join(img_dir, name))
            with open(os.path.join(root, f"Domain{i}_train.txt"), "w") as f:
                f.write("\n".join(train_list) + "\n")
        elif dataset in ("prostate", "MNMS"):
            for phase, n in (("train", n_train), ("test", n_test)):
                img_dir = os.path.join(root, dom, phase, "image")
                msk_dir = os.path.join(root, dom, phase, "mask")
                os.makedirs(img_dir, exist_ok=True)
                os.makedirs(msk_dir, exist_ok=True)
                for k in range(n):
                    img, msk = _make_pair(rng, dataset, size)
                    name = f"{phase}_{k:03d}.png"
                    img.save(os.path.join(img_dir, name))
                    msk.save(os.path.join(msk_dir, name))
        elif dataset == "BUSI":
            # one flat folder; last 20% of sorted order becomes test
            d = os.path.join(root, dom)
            os.makedirs(d, exist_ok=True)
            total = n_train + n_test
            for k in range(total):
                img, msk = _make_pair(rng, dataset, size)
                img.save(os.path.join(d, f"{dom} ({k:03d}).png"))
                msk.save(os.path.join(d, f"{dom} ({k:03d})_mask.png"))
    return root


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="fundus",
                    choices=["fundus", "prostate", "BUSI", "MNMS"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--n_train", type=int, default=8)
    ap.add_argument("--n_test", type=int, default=3)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    generate(args.dataset, args.root, args.n_train, args.n_test, args.size,
             args.seed)
    print(f"wrote synthetic {args.dataset} dataset to {args.root}")


if __name__ == "__main__":
    main()
