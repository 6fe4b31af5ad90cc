"""Segmentation dataset utilities (the port's copy of
ust_run_tpu/data/dl_utils.py, with `cross_entropy2d` in torch).

Capability parity with reference dataloaders/utils.py:16-204: label
colormaps, segmap encode/decode, poly LR helper, IoU/Dice summaries, and
the morphological post-processing (hole filling + small connected
component removal). skimage is not a dependency here; connected
components come from scipy.ndimage.label.
"""

import numpy as np
import torch
from scipy import ndimage


def cityscapes_colormap():
    return np.asarray([
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32]], np.uint8)


def pascal_colormap(n=21):
    """Standard PASCAL VOC bit-shuffled colormap."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c = i
        r = g = b = 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap


def decode_segmap(label_mask, dataset="cityscapes"):
    """Class-index map -> RGB visualization."""
    cmap = cityscapes_colormap() if dataset == "cityscapes" \
        else pascal_colormap()
    label_mask = np.asarray(label_mask, np.int64)
    out = np.zeros(label_mask.shape + (3,), np.uint8)
    for c in range(len(cmap)):
        out[label_mask == c] = cmap[c]
    return out


def encode_segmap(rgb_mask, dataset="cityscapes"):
    """RGB visualization -> class-index map."""
    cmap = cityscapes_colormap() if dataset == "cityscapes" \
        else pascal_colormap()
    rgb_mask = np.asarray(rgb_mask)
    out = np.full(rgb_mask.shape[:2], 255, np.uint8)
    for c, color in enumerate(cmap):
        out[np.all(rgb_mask == color, axis=-1)] = c
    return out


def lr_poly(base_lr, iter_, max_iter, power):
    """Poly LR (dataloaders/utils.py)."""
    return base_lr * ((1 - float(iter_) / max_iter) ** power)


def cross_entropy2d(logits, target, ignore_index=255, weight=None,
                    size_average=True, batch_average=True):
    """Vestigial 2-D CE (dataloaders/utils.py:128-144, reached from no
    entry point): sum-reduced pixel CE with an ignore id, then optional
    /HW and /N. logits: (N,H,W,C) tensor or array; target: (N,H,W) int."""
    logits = torch.as_tensor(logits, dtype=torch.float32)
    target = torch.as_tensor(target).to(torch.int64)
    n, h, w, c = logits.shape
    safe = torch.clamp(target, 0, c - 1)
    logp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                        safe[..., None])[..., 0]
    if weight is not None:
        logp = logp * torch.as_tensor(weight, dtype=torch.float32)[safe]
    loss = -(logp * (target != ignore_index)).sum()
    if size_average:
        loss = loss / (h * w)
    if batch_average:
        loss = loss / n
    return loss


def get_iou(pred, gt, n_classes):
    """Mean per-class IoU over a batch of class maps."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    ious = []
    for c in range(n_classes):
        p = pred == c
        g = gt == c
        union = np.logical_or(p, g).sum()
        if union == 0:
            continue
        ious.append(np.logical_and(p, g).sum() / union)
    return float(np.mean(ious)) if ious else 0.0


def get_dice(pred, gt):
    """Binary dice over boolean maps."""
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    denom = pred.sum() + gt.sum()
    if denom == 0:
        return 1.0
    return 2.0 * np.logical_and(pred, gt).sum() / denom


def post_processing(prediction):
    """Fill holes, then drop connected components smaller than 20% of the
    largest (reference dataloaders/utils.py:182-204 semantics)."""
    prediction = np.asarray(prediction, bool)
    filled = ndimage.binary_fill_holes(prediction)
    labels, n = ndimage.label(filled)
    if n == 0:
        return filled
    sizes = ndimage.sum(filled, labels, range(1, n + 1))
    threshold = 0.2 * sizes.max()
    keep = np.zeros_like(filled)
    for i, s in enumerate(sizes, start=1):
        if s >= threshold:
            keep |= labels == i
    return keep
