"""Device-side weak/strong augmentation (port of ust_run_tpu/ops/augment.py).

  weak   = RandomScaleCrop -> RandomScaleRotate(+-20) -> RandomHorizontalFlip
           -> elastic_transform, composed into ONE coordinate map per image
           (custom_transforms.py:197-256, 311-344, 387-397, 507-550)
  strong = Brightness -> Contrast -> GaussianBlur with PIL uint8 rounding
           (custom_transforms.py:60-118)
  norm   = x/127.5 - 1

The per-sample draws are made apart from the code that applies them:
`weak_draws` / `strong_draws` return tensors, and `weak_augment_apply` /
`strong_augment_apply` take them, so a test can feed the JAX package's
draws to the port. The elastic fields come from the uniform-field kernel
(ops/rng.py) and are smoothed by a band-matrix product in float32 (TF32
off: `torch.backends.cuda.matmul.allow_tf32` is False, PyTorch's default,
and the trainer sets it so).
"""

import functools
import math

import numpy as np
import torch

from ust_run_tpu_torch.ops.resample import (bilinear_gather, gaussian_kernel,
                                            nearest_gather,
                                            separable_gaussian_blur)
from ust_run_tpu_torch.ops.rng import uniform_batch


def _gauss_band_matrix(size, sigma):
    """Dense (size,size) zero-padded 1-D gaussian filter matrix
    (augment.py:43-61; scipy truncate=4.0, mode='constant')."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    k = k / k.sum()
    m = np.zeros((size, size), np.float64)
    for t, kv in enumerate(k):
        off = t - radius
        idx = np.arange(max(0, -off), min(size, size - off))
        m[idx, idx + off] += kv
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _smoothing_matrix(size, device):
    """The sigma = 0.08*S band matrix on `device`, copied there once per
    (size, device): a host-to-device copy each step would wait on the
    device."""
    return torch.as_tensor(_gauss_band_matrix(size, 0.08 * size),
                           device=device)


def smooth_fields(raw):
    """(F,S,S) float32 -> gaussian_filter(sigma=0.08*S, mode='constant') of
    each field, as m @ field @ m.T in float32 (augment.py:203-205)."""
    m = _smoothing_matrix(raw.shape[-1], raw.device)
    return torch.matmul(torch.matmul(m, raw), m.T)


def weak_draws(n, generator, device):
    """Per-sample draws of the weak chain (augment.py:84-108), as tensors."""
    u = torch.rand((8, n), generator=generator, device=device)
    deg = torch.randint(-20, 21, (n,), generator=generator, device=device)
    return dict(do_scale=u[0] > 0.5, scale_w=1.0 + 0.5 * u[1],
                scale_h=1.0 + 0.5 * u[2], u_x=u[3], u_y=u[4],
                do_rot=u[5] > 0.5, deg=deg.to(torch.float32),
                do_flip=u[6] > 0.5, do_el=u[7] > 0.5)


def weak_augment_apply(imgs, masks, dx, dy, draws, *, size, fillcolor):
    """The composed weak chain (augment.py:75-148), batched.

    imgs (B,S,S,C) uint8 or float32 in [0,255]; masks (B,S,S,K); dx/dy
    (B,S,S) smoothed elastic displacements; draws as `weak_draws`.
    Rotation fills the image with 0 and the mask with `fillcolor`; elastic
    out-of-bounds fills the image with 0 and clamps the mask. Returns
    float32 (img', mask')."""
    s = size
    sf = float(s)
    dev = imgs.device

    def col(v):                                   # (B,) -> (B,1,1)
        return v[:, None, None]

    do_scale = col(draws["do_scale"])
    w = torch.where(do_scale, torch.floor(col(draws["scale_w"]) * sf), sf)
    h = torch.where(do_scale, torch.floor(col(draws["scale_h"]) * sf), sf)
    # random.randint(0, w - S) is INCLUSIVE of the upper bound
    x1 = torch.floor(col(draws["u_x"]) * (w - sf + 1.0))
    y1 = torch.floor(col(draws["u_y"]) * (h - sf + 1.0))
    theta = torch.where(col(draws["do_rot"]),
                        col(draws["deg"]) * (math.pi / 180.0), 0.0)
    do_flip = col(draws["do_flip"])
    do_el = col(draws["do_el"])
    dx = torch.where(do_el, dx, 0.0)
    dy = torch.where(do_el, dy, 0.0)

    ii = torch.arange(s, dtype=torch.float32, device=dev)[None, :, None]
    jj = torch.arange(s, dtype=torch.float32, device=dev)[None, None, :]
    q_r = ii + dx
    q_c = jj + dy
    el_oob = (q_r < 0) | (q_r > sf - 1) | (q_c < 0) | (q_c > sf - 1)
    qm_r = torch.clamp(torch.round(q_r), 0.0, sf - 1)
    qm_c = torch.clamp(torch.round(q_c), 0.0, sf - 1)
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    ctr = (sf - 1.0) / 2.0

    def chain(rr, cc):
        cc = torch.where(do_flip, (sf - 1.0) - cc, cc)
        rr_c = rr - ctr
        cc_c = cc - ctr
        r_r = cos_t * rr_c - sin_t * cc_c + ctr
        r_c = sin_t * rr_c + cos_t * cc_c + ctr
        rot_oob = ((r_r < -0.5) | (r_r > sf - 0.5) |
                   (r_c < -0.5) | (r_c > sf - 0.5))
        s_r = (y1 + r_r + 0.5) * sf / h - 0.5
        s_c = (x1 + r_c + 0.5) * sf / w - 0.5
        return s_r, s_c, rot_oob

    s_r, s_c, rot_oob = chain(q_r, q_c)
    sm_r, sm_c, rot_oob_m = chain(qm_r, qm_c)

    img_v = bilinear_gather(imgs, s_r, s_c)
    img_out = torch.where((el_oob | rot_oob)[..., None], 0.0, img_v)
    img_out = torch.round(torch.clamp(img_out, 0.0, 255.0))
    mask_v = nearest_gather(masks, sm_r, sm_c).to(torch.float32)
    mask_out = torch.where(rot_oob_m[..., None], float(fillcolor), mask_v)
    return img_out, mask_out


def weak_augment_batch(imgs, masks, *, size, fillcolor, generator,
                       host_generator):
    """Weak augmentation of a batch (augment.py:189-213): 2n uniform
    fields from the RNG kernel (seeded from the CPU `host_generator`),
    smoothed and scaled by 2S, then the composed chain with per-sample
    draws from `generator` (on the batch's device)."""
    n = imgs.shape[0]
    dev = imgs.device
    masks = masks.to(torch.float32)
    raw = uniform_batch(2 * n, size, generator=host_generator,
                        device=dev) * 2.0 - 1.0
    sm = smooth_fields(raw)
    alpha = 2.0 * size
    draws = weak_draws(n, generator, dev)
    return weak_augment_apply(imgs, masks, sm[:n] * alpha, sm[n:] * alpha,
                              draws, size=size, fillcolor=fillcolor)


def strong_draws(n, generator, device):
    """Per-sample draws of the strong chain (augment.py:154-173)."""
    u = torch.rand((3, n), generator=generator, device=device)
    return dict(u_bright=u[0], u_contrast=u[1], sigma=0.1 + 1.9 * u[2])


def strong_augment_apply(imgs, draws, *, min_v, max_v, blur_radius):
    """Brightness -> Contrast -> GaussianBlur on (B,S,S,C) in [0,255] with
    PIL-faithful uint8 rounding between stages (augment.py:151-176)."""
    def col(v):                                   # (B,) -> (B,1,1,1)
        return v[:, None, None, None]

    v1 = min_v + (max_v - min_v) * col(draws["u_bright"])
    imgs = torch.round(torch.clamp(imgs * v1, 0.0, 255.0))
    v2 = min_v + (max_v - min_v) * col(draws["u_contrast"])
    if imgs.shape[-1] == 3:
        gray = torch.floor((imgs[..., 0] * 299 + imgs[..., 1] * 587 +
                            imgs[..., 2] * 114) / 1000.0)
    else:
        gray = imgs[..., 0]
    mean = torch.floor(torch.mean(gray, dim=(1, 2)) + 0.5)
    mean = col(mean)
    imgs = torch.round(torch.clamp(mean + v2 * (imgs - mean), 0.0, 255.0))
    kern = gaussian_kernel(draws["sigma"], blur_radius)
    imgs = separable_gaussian_blur(imgs, kern)
    return torch.round(torch.clamp(imgs, 0.0, 255.0))


def strong_augment_batch(imgs, *, min_v, max_v, blur_radius, generator):
    return strong_augment_apply(
        imgs, strong_draws(imgs.shape[0], generator, imgs.device),
        min_v=min_v, max_v=max_v, blur_radius=blur_radius)


def normalize(img):
    """Normalize_tf: x/127.5 - 1 (custom_transforms.py:650-684)."""
    return img / 127.5 - 1.0


def denormalize(img):
    """(x+1)*127.5, used before FDA (train.py:630-631)."""
    return (img + 1.0) * 127.5


def blur_radius_for(patch_size):
    """kernel_size=int(0.1*patch); radius=kernel//2 (train.py:456)."""
    return int(0.1 * patch_size) // 2
