"""Per-sample Dice on device tensors (port of ust_run_tpu/utils/metrics.py,
the `*_jax` half).

Reference smoothing (utils/metrics.py:139-143): empty prediction AND
empty ground truth -> 0.0, otherwise (2*inter + 1.0) / (1.001 + |p| + |g|).
"""

import torch


def _dice(seg, gt):
    """Per-map smoothed dice over all axes but the leading batch axis."""
    seg = seg.to(torch.float32)
    gt = gt.to(torch.float32)
    axes = tuple(range(1, seg.ndim))
    inter = torch.sum(seg * gt, dim=axes)
    seg_n = torch.sum(seg, dim=axes)
    gt_n = torch.sum(gt, dim=axes)
    dice = (2.0 * inter + 1.0) / (1.001 + seg_n + gt_n)
    both_empty = (seg_n == 0) & (gt_n == 0)
    return torch.where(both_empty, torch.zeros_like(dice), dice)


def dice_per_part(pred, target, n_part):
    """(n_part, B) per-sample dice (train.py:220 dispatch table).

    1 part: binary maps (B,H,W); 2 parts: cup/disc planes (B,H,W,2) NHWC;
    3 parts: class maps (B,H,W) with classes 1..3."""
    if n_part == 1:
        return _dice(pred, target)[None, :]
    if n_part == 2:
        return torch.stack([_dice(pred[..., 0], target[..., 0]),
                            _dice(pred[..., 1], target[..., 1])])
    if n_part == 3:
        return torch.stack([_dice(pred == c, target == c) for c in (1, 2, 3)])
    raise ValueError(f"unsupported n_part={n_part}")
