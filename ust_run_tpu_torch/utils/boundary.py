"""Boundary metrics on the host: Dice (dc), Jaccard (jc), HD95 and ASD
(the port's own copy of ust_run_tpu/utils/boundary.py).

The reference calls `medpy.metric.binary.{dc,jc,hd95,asd}` per sample per
part during evaluation (train.py:306-325, test.py:118-129). These are the
same definitions on top of scipy, and the plain version of the native
engine (utils/boundary_native.py):

  * surface voxels = img XOR erosion(img) with a connectivity-1 cross
    structuring element;
  * surface distances = Euclidean distance transform of the complement of
    the other surface, sampled at this surface's voxels;
  * asd(a, b)  = mean of one-sided surface distances a->b;
  * hd95(a, b) = 95th percentile of the symmetric set of surface distances.

The evaluation convention "empty prediction => hd95 = asd = 100" lives at
the call site (reference train.py:313-315), in engine/evaluator.py.
"""

import numpy as np
from scipy import ndimage


def dc(pred, gt):
    """Dice coefficient 2|A∩B| / (|A|+|B|); 0.0 when both empty."""
    pred = np.asarray(pred, dtype=bool)
    gt = np.asarray(gt, dtype=bool)
    denom = pred.sum() + gt.sum()
    if denom == 0:
        return 0.0
    return 2.0 * np.logical_and(pred, gt).sum() / float(denom)


def jc(pred, gt):
    """Jaccard index |A∩B| / |A∪B|; 0.0 when the union is empty."""
    pred = np.asarray(pred, dtype=bool)
    gt = np.asarray(gt, dtype=bool)
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 0.0
    return np.logical_and(pred, gt).sum() / float(union)


def _surface_distances(a, b):
    """One-sided surface distances from surface(a) to surface(b)."""
    a = np.asarray(a, dtype=bool)
    b = np.asarray(b, dtype=bool)
    if not a.any() or not b.any():
        raise ValueError("surface distance is undefined for empty masks")
    footprint = ndimage.generate_binary_structure(a.ndim, 1)
    a_border = a ^ ndimage.binary_erosion(a, structure=footprint, iterations=1)
    b_border = b ^ ndimage.binary_erosion(b, structure=footprint, iterations=1)
    return ndimage.distance_transform_edt(~b_border)[a_border]


def asd(pred, gt):
    """Average (one-sided) surface distance pred -> gt."""
    return float(_surface_distances(pred, gt).mean())


def hd95(pred, gt):
    """95th percentile of symmetric surface distances."""
    s1 = _surface_distances(pred, gt)
    s2 = _surface_distances(gt, pred)
    return float(np.percentile(np.hstack([s1, s2]), 95))


def boundary_metrics(pred, gt):
    """(dc, jc, hd95, asd) of two 2-D masks; hd95 and asd are NaN when
    either mask is empty (the native engine's contract)."""
    if np.any(pred) and np.any(gt):
        return dc(pred, gt), jc(pred, gt), hd95(pred, gt), asd(pred, gt)
    return dc(pred, gt), jc(pred, gt), float("nan"), float("nan")
