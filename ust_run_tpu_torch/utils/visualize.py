"""Prediction overlays for --save_img (the port's own copy of
ust_run_tpu/utils/visualize.py; reference utils/util.py:299-390:
draw_contour / draw_mask_and_save used by test.py:110-113).

Without cv2: per-part colored mask overlay plus a 1-pixel contour (mask
XOR erosion), written as PNG via PIL. numpy, scipy and PIL only; the
callers copy the masks to the host first.
"""

import os

import numpy as np
from PIL import Image
from scipy import ndimage

# one color per part (cup/disc, base, lv/myo/rv)
_COLORS = [(255, 0, 0), (0, 255, 0), (0, 0, 255)]


def _contour(mask):
    er = ndimage.binary_erosion(mask, iterations=1)
    return mask & ~er


def overlay(image_u8, part_masks, alpha=0.35):
    """image_u8: (H,W,C) uint8; part_masks: (H,W,P) bool. Returns RGB."""
    img = image_u8
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    out = img.astype(np.float32)
    for i in range(part_masks.shape[-1]):
        m = part_masks[..., i].astype(bool)
        color = np.asarray(_COLORS[i % len(_COLORS)], np.float32)
        out[m] = (1 - alpha) * out[m] + alpha * color
        out[_contour(m)] = color
    return out.clip(0, 255).astype(np.uint8)


def draw_mask_and_save(image_u8, pred_parts, gt_parts, out_dir, name):
    """Save side-by-side prediction/ground-truth overlays."""
    os.makedirs(out_dir, exist_ok=True)
    pred_img = overlay(image_u8, pred_parts)
    gt_img = overlay(image_u8, gt_parts)
    combo = np.concatenate([pred_img, gt_img], axis=1)
    Image.fromarray(combo).save(os.path.join(out_dir, name))


# ---- reference-style contour variants (utils/util.py:299-363) ----------

def draw_contour(image, label, color):
    """Paint the 1-pixel outer contour of `label` onto `image` in-place
    (util.py:299-317's dilate-minus-binary contour, sans cv2)."""
    binary = label > 0
    dilated = ndimage.binary_dilation(binary, np.ones((3, 3), bool))
    image[dilated & ~binary] = color
    return image


def make_prediction(image, *predictions):
    """Draw each (label_stack, color) contour set onto `image`
    (util.py:320-344). label_stack: (H,W) or (C,H,W)."""
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    for prediction, color in predictions:
        if prediction.ndim == 2:
            prediction = prediction[None]
        for class_map in prediction:
            image = draw_contour(image, class_map, color)
    return image


def draw_contour_and_save(img, pred, mask, save_path):
    """Contour-style overlay artifact (util.py:346-363): min-max
    normalized image, green/blue/… prediction contours, red ground
    truth. img: (H,W) or (C,H,W) float; pred/mask: (H,W) or (C,H,W)."""
    color_gt = (255, 0, 0)
    color_pred = [(0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255)]
    img = np.asarray(img, np.float32)
    pred = np.asarray(pred)
    mask = np.asarray(mask)
    if pred.ndim == 2:
        pred = pred[None]
    if mask.ndim == 2:
        mask = mask[None]
    if img.ndim == 2:
        img = img[None]
    if img.shape[0] == 1:
        img = np.repeat(img, 3, axis=0)
    rng = img.max() - img.min()
    img = (img - img.min()) / (rng if rng else 1.0) * 255
    canvas = img.transpose(1, 2, 0)
    for i in range(pred.shape[0]):
        canvas = make_prediction(canvas, (pred[i], color_pred[i]),
                                 (mask[i], color_gt))
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    Image.fromarray(canvas.clip(0, 255).astype(np.uint8)).save(save_path)
