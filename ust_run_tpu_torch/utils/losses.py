"""Segmentation losses (port of ust_run_tpu/utils/losses.py): the main
path's CE+Dice, and the auxiliary losses no entry point reaches
(`dice_loss_plain`, `focal_loss`, `softmax_{dice,mse,kl}_loss`,
`entropy_loss`, `entropy_map`; losses.py:130-211).

Conventions (all NHWC):
  * `logits`: (B, H, W, C) raw network outputs.
  * multilabel (fundus) targets: (B, H, W, C) float {0,1}; masks share
    that shape.
  * multiclass targets: (B, H, W) int class maps; masks are (B, H, W, 1).

Reduction quirks of the reference kept exactly:
  * masked CE is `(ce * mask).mean()`: the mean is over ALL pixels
    (train.py:826-836);
  * `DiceLossWithMask` is one global soft dice over the whole volume in
    multilabel mode, per-class global dice otherwise, and leaves class 0
    unmasked (losses.py:207-213).

Every loss is a ratio of sums over the batch, so each is computed in two
halves: the sums of a batch (the CE mean, the dice sums of
`_*_dice_sums`), then the ratios (`_soft_dice`, `_multiclass_dice`).
Under a mesh `ce_plus_dice` sums the ranks' shares (samples x rows) of
the CE mean and their dice sums before the ratios (`mesh.sum_replicated`),
which gives the loss of the global batch; averaging the ranks' losses
would not.
"""

import numpy as np
import torch
import torch.nn.functional as F

_SMOOTH = 1e-10  # losses.py:218,228


def _dice_sums(score, target, mask=None):
    """(sum(s*t), sum(t*t), sum(s*s)) over all axes."""
    score = score.to(torch.float32)
    target = target.to(torch.float32)
    if mask is not None:
        mask = mask.to(torch.float32)
        inter = torch.sum(score * target * mask)
        t_sum = torch.sum(target * target * mask)
        s_sum = torch.sum(score * score * mask)
    else:
        inter = torch.sum(score * target)
        t_sum = torch.sum(target * target)
        s_sum = torch.sum(score * score)
    return inter, t_sum, s_sum


def _soft_dice(inter, t_sum, s_sum):
    """1 - (2*sum(s*t)+eps) / (sum(t*t)+sum(s*s)+eps)."""
    return 1.0 - (2.0 * inter + _SMOOTH) / (s_sum + t_sum + _SMOOTH)


def _multilabel_dice_sums(logits, target, mask=None):
    return _dice_sums(torch.sigmoid(logits.to(torch.float32)), target, mask)


def _multiclass_dice_sums(logits, target, n_classes, mask=None):
    """Each class's `_dice_sums`; class 0 is never masked."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    sums = []
    for c in range(n_classes):
        tgt_c = (target == c).to(torch.float32)
        mask_c = None
        if mask is not None and c > 0:
            mask_c = (mask[..., 0] == 1).to(torch.float32)
        sums.append(_dice_sums(probs[..., c], tgt_c, mask_c))
    return sums


def _multiclass_dice(sums):
    loss = 0.0
    for s in sums:
        loss = loss + _soft_dice(*s)
    return loss / len(sums)


def dice_loss_multilabel(logits, target, mask=None):
    """Sigmoid probabilities, one global dice (losses.py:236-249)."""
    return _soft_dice(*_multilabel_dice_sums(logits, target, mask))


def dice_loss_multiclass(logits, target, n_classes, mask=None):
    """Softmax probabilities, per-class global dice averaged over classes;
    class 0 is never masked (losses.py:207-213). target (B,H,W) int,
    mask (B,H,W,1) or None."""
    return _multiclass_dice(_multiclass_dice_sums(logits, target, n_classes,
                                                  mask))


def bce_with_logits(logits, target):
    """Elementwise BCE-with-logits, reduction='none' (train.py:516):
    max(x,0) - x*t + log(1+exp(-|x|))."""
    x = logits.to(torch.float32)
    t = target.to(torch.float32)
    return torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def softmax_ce(logits, target):
    """Elementwise softmax cross-entropy, reduction='none' (train.py:519).
    A one-hot contraction, as in the JAX package (losses.py:90-105): an
    out-of-range target gives 0. logits (B,H,W,C), target (B,H,W) int."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (target[..., None].to(torch.int64) == classes).to(torch.float32)
    return -torch.sum(logp * onehot, dim=-1)


def ce_plus_dice(logits, target, *, multilabel, n_classes, mask=None,
                 mesh=None, rows=None, height=None):
    """`ce.mean() + dice(...)` (train.py:816-838); masked CE is
    `(ce * mask).mean()` over all elements. With `mesh`, the arguments are
    this rank's slice (possibly empty) of a global batch of `rows` samples
    of `height` rows each (default: the slice's; a space axis gives each
    rank a slab of them) and the loss is the global batch's: this rank's
    share of the CE mean and its dice sums are summed over the ranks
    before the ratios."""
    if multilabel:
        ce = bce_with_logits(logits, target)
        if mask is not None:
            ce = ce * mask.to(torch.float32)
        sums = [_multilabel_dice_sums(logits, target, mask)]
    else:
        ce = softmax_ce(logits, target)
        if mask is not None:
            ce = ce * mask[..., 0].to(torch.float32)
        sums = _multiclass_dice_sums(logits, target, n_classes, mask)
    if mesh is None:
        ce_mean = torch.mean(ce)
    else:
        # the mean times this rank's share of the elements: at world 1
        # exactly torch.mean, so one rank computes what no mesh computes
        if ce.numel():
            per_sample = ce[0].numel() if height is None \
                else ce[0].numel() // ce.shape[1] * height
            ce_mean = torch.mean(ce) * (ce.numel() / (rows * per_sample))
        else:
            ce_mean = torch.sum(ce)
        flat = mesh.sum_replicated(
            torch.stack([ce_mean] + [t for s in sums for t in s]))
        ce_mean, *rest = flat.unbind()
        sums = [rest[i:i + 3] for i in range(0, len(rest), 3)]
    if multilabel:
        return ce_mean + _soft_dice(*sums[0])
    return ce_mean + _multiclass_dice(sums)


def dice_loss_plain(score, target, smooth=1e-5):
    """Unmasked soft dice with 1e-5 smoothing (losses.py:8-16 /
    DiceLoss._dice_loss at :169-177)."""
    score = score.to(torch.float32)
    target = target.to(torch.float32)
    inter = torch.sum(score * target)
    return 1.0 - (2.0 * inter + smooth) / (
        torch.sum(score * score) + torch.sum(target * target) + smooth)


def focal_loss(logits, target, gamma=2.0, alpha=None, size_average=True):
    """Multi-class focal loss (reference FocalLoss, losses.py:119-153).
    logits: (..., C); target: (...) int. alpha: None | scalar | (C,)
    list."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    target = target.to(torch.int64)
    logpt = torch.gather(logp, -1, target[..., None])[..., 0]
    pt = torch.exp(logpt)
    if alpha is not None:
        alpha = torch.as_tensor(alpha, dtype=torch.float32)
        if alpha.ndim == 0:
            alpha = torch.stack([alpha, 1 - alpha])
        logpt = logpt * alpha.to(logits.device)[target]
    loss = -((1 - pt) ** gamma) * logpt
    return torch.mean(loss) if size_average else torch.sum(loss)


def softmax_dice_loss(input_logits, target_logits):
    """Per-class soft dice between two softmax outputs, averaged over
    classes (losses.py:39-56)."""
    a = torch.softmax(input_logits, dim=-1)
    b = torch.softmax(target_logits, dim=-1)
    n = input_logits.shape[-1]
    total = 0.0
    for c in range(n):
        score, target = a[..., c], b[..., c]
        inter = torch.sum(score * target)
        total = total + 1.0 - (2 * inter + 1e-5) / (
            torch.sum(score) + torch.sum(target) + 1e-5)
    return total / n


def softmax_mse_loss(input_logits, target_logits, sigmoid=False):
    """Elementwise MSE between softmax/sigmoid outputs (losses.py:65-82)."""
    if sigmoid:
        a, b = torch.sigmoid(input_logits), torch.sigmoid(target_logits)
    else:
        a = torch.softmax(input_logits, dim=-1)
        b = torch.softmax(target_logits, dim=-1)
    return (a - b) ** 2


def softmax_kl_loss(input_logits, target_logits, sigmoid=False):
    """Mean KL(target || input) (losses.py:85-104): torch's
    F.kl_div(logp, q, reduction='mean') over all elements."""
    if sigmoid:
        logp = torch.log(torch.sigmoid(input_logits))
        q = torch.sigmoid(target_logits)
    else:
        logp = F.log_softmax(input_logits, dim=-1)
        q = torch.softmax(target_logits, dim=-1)
    return torch.mean(q * (torch.log(torch.clamp(q, min=1e-30)) - logp))


def entropy_loss(probs, n_classes=2):
    """Normalized mean entropy (losses.py:30-36)."""
    ent = -torch.sum(probs * torch.log(probs + 1e-6), dim=-1) \
        / float(np.log(n_classes))
    return torch.mean(ent)


def entropy_map(probs):
    """Per-pixel entropy map (losses.py:278-281)."""
    return -torch.sum(probs * torch.log(probs + 1e-6), dim=-1, keepdim=True)
