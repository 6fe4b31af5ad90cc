"""Plain CE+Dice and the per-sample Dice of the SSL step, NHWC.

Frozen copies of ust_run_tpu_torch/utils/losses.py (`ce_plus_dice`
without a mesh and its helpers) and utils/metrics.py (the device Dice),
at the commit named in `benchmarks/reference/__init__.py`.
"""

import torch
import torch.nn.functional as F

_SMOOTH = 1e-10


def _dice_sums(score, target, mask=None):
    score = score.to(torch.float32)
    target = target.to(torch.float32)
    if mask is not None:
        mask = mask.to(torch.float32)
        return (torch.sum(score * target * mask),
                torch.sum(target * target * mask),
                torch.sum(score * score * mask))
    return (torch.sum(score * target), torch.sum(target * target),
            torch.sum(score * score))


def _soft_dice(inter, t_sum, s_sum):
    return 1.0 - (2.0 * inter + _SMOOTH) / (s_sum + t_sum + _SMOOTH)


def _multiclass_dice(logits, target, n_classes, mask=None):
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    loss = 0.0
    for c in range(n_classes):
        mask_c = None
        if mask is not None and c > 0:
            mask_c = (mask[..., 0] == 1).to(torch.float32)
        loss = loss + _soft_dice(*_dice_sums(
            probs[..., c], (target == c).to(torch.float32), mask_c))
    return loss / n_classes


def ce_plus_dice(logits, target, *, multilabel, n_classes, mask=None):
    """mean(ce * mask) over every element + the soft Dice: one global
    Dice of the sigmoid outputs (multilabel), or the per-class Dice of the
    softmax outputs with class 0 unmasked."""
    x = logits.to(torch.float32)
    if multilabel:
        t = target.to(torch.float32)
        ce = torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
        if mask is not None:
            ce = ce * mask.to(torch.float32)
        return torch.mean(ce) + _soft_dice(
            *_dice_sums(torch.sigmoid(x), t, mask))
    logp = F.log_softmax(x, dim=-1)
    classes = torch.arange(x.shape[-1], device=x.device)
    onehot = (target[..., None].to(torch.int64) == classes).to(torch.float32)
    ce = -torch.sum(logp * onehot, dim=-1)
    if mask is not None:
        ce = ce * mask[..., 0].to(torch.float32)
    return torch.mean(ce) + _multiclass_dice(x, target, n_classes, mask)


def _dice(seg, gt):
    seg = seg.to(torch.float32)
    gt = gt.to(torch.float32)
    axes = tuple(range(1, seg.ndim))
    inter = torch.sum(seg * gt, dim=axes)
    seg_n = torch.sum(seg, dim=axes)
    gt_n = torch.sum(gt, dim=axes)
    dice = (2.0 * inter + 1.0) / (1.001 + seg_n + gt_n)
    return torch.where((seg_n == 0) & (gt_n == 0), torch.zeros_like(dice),
                       dice)


def dice_per_part(pred, target, n_part):
    """(n_part, B) per-sample Dice: binary maps, cup/disc planes, or
    class maps with classes 1..3."""
    if n_part == 1:
        return _dice(pred, target)[None, :]
    if n_part == 2:
        return torch.stack([_dice(pred[..., 0], target[..., 0]),
                            _dice(pred[..., 1], target[..., 1])])
    return torch.stack([_dice(pred == c, target == c) for c in (1, 2, 3)])
