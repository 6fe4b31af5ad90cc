"""Dice metrics (port of ust_run_tpu/utils/metrics.py).

  * host (`*_np`): numpy, the reference formulas (utils/metrics.py:114-231;
    a copy of the JAX package's);
  * device: the same formula on tensors, per sample (`dice_coeff`,
    `dice_coeff_2label`, `dice_coeff_3label`, dispatched by
    `dice_per_part`), used by the step and the evaluator.

Reference smoothing (utils/metrics.py:139-143): empty prediction AND
empty ground truth -> 0.0, otherwise (2*inter + 1.0) / (1.001 + |p| + |g|).
"""

import numpy as np
import torch


def dice_coefficient_np(binary_segmentation, binary_gt_label):
    """Smoothed Dice between two binary 2D maps (utils/metrics.py:114-146)."""
    seg = np.asarray(binary_segmentation, dtype=bool)
    gt = np.asarray(binary_gt_label, dtype=bool)
    inter = float(np.sum(np.logical_and(seg, gt)))
    seg_n = float(np.sum(seg))
    gt_n = float(np.sum(gt))
    if seg_n == 0 and gt_n == 0:
        return 0.0
    return (2 * inter + 1.0) / (1.001 + seg_n + gt_n)


def dice_coeff_np(pred, target, ret_arr=False):
    """Binary Dice over a batch (utils/metrics.py:149-174).

    pred/target: (H,W) or (B,H,W). Returns a 1-element list (one "part").
    """
    pred = np.asarray(pred)
    target = np.asarray(target)
    if pred.ndim == 2:
        return [dice_coefficient_np(pred, target)]
    all_dice = [dice_coefficient_np(pred[i], target[i])
                for i in range(pred.shape[0])]
    if ret_arr:
        return [np.array(all_dice)]
    return [sum(all_dice) / len(all_dice)]


def dice_coeff_2label_np(pred, target, ret_arr=False):
    """Cup/disc two-plane Dice (utils/metrics.py:176-201).

    pred/target: (B,2,H,W) channel-first or (2,H,W).
    """
    pred = np.asarray(pred)
    target = np.asarray(target)
    if pred.ndim == 3:
        return [dice_coefficient_np(pred[0], target[0]),
                dice_coefficient_np(pred[1], target[1])]
    cup = [dice_coefficient_np(pred[i, 0], target[i, 0])
           for i in range(pred.shape[0])]
    disc = [dice_coefficient_np(pred[i, 1], target[i, 1])
            for i in range(pred.shape[0])]
    if ret_arr:
        return [np.array(cup), np.array(disc)]
    return [sum(cup) / len(cup), sum(disc) / len(disc)]


def dice_coeff_3label_np(pred, target, ret_arr=False):
    """LV/MYO/RV three-class Dice (utils/metrics.py:203-231).

    pred/target: (B,H,W) integer class maps with classes 1..3.
    """
    pred = np.asarray(pred)
    target = np.asarray(target)
    if pred.ndim == 2:
        return [dice_coefficient_np(pred == c, target == c)
                for c in (1, 2, 3)]
    parts = []
    for c in (1, 2, 3):
        parts.append([dice_coefficient_np(pred[i] == c, target[i] == c)
                      for i in range(pred.shape[0])])
    if ret_arr:
        return [np.array(p) for p in parts]
    return [sum(p) / len(p) for p in parts]


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


def dice_coeff(pred, target):
    """Binary per-sample Dice. pred/target: (B,H,W). Returns (1,B)."""
    return _dice(pred, target)[None, :]


def dice_coeff_2label(pred, target):
    """Cup/disc per-sample Dice. pred/target: (B,H,W,2) NHWC. Returns
    (2,B)."""
    return torch.stack([_dice(pred[..., 0], target[..., 0]),
                        _dice(pred[..., 1], target[..., 1])])


def dice_coeff_3label(pred, target):
    """3-class per-sample Dice. pred/target: (B,H,W) int maps with classes
    1..3. Returns (3,B)."""
    return torch.stack([_dice(pred == c, target == c) for c in (1, 2, 3)])


def dice_per_part(pred, target, n_part):
    """(n_part, B) per-sample dice (train.py:220 dispatch table).

    1 part: binary maps (B,H,W); 2 parts: cup/disc planes (B,H,W,2) NHWC;
    3 parts: class maps (B,H,W) with classes 1..3."""
    if n_part == 1:
        return dice_coeff(pred, target)
    if n_part == 2:
        return dice_coeff_2label(pred, target)
    if n_part == 3:
        return dice_coeff_3label(pred, target)
    raise ValueError(f"unsupported n_part={n_part}")
