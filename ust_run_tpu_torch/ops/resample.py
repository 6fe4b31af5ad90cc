"""Coordinate-based image resampling (port of ust_run_tpu/ops/resample.py).

Batched: every function takes a leading batch axis where the JAX package
maps one image at a time. Not `F.grid_sample`, whose border rules differ.
"""

import functools

import numpy as np
import torch


def bilinear_gather(imgs, rows, cols):
    """Sample `imgs` (B,H,W,C) at fractional coordinates rows/cols
    (B, ...), bilinear, edge-clamped -> float32 (B, ..., C).

    As resample.py:18-83: r0/c0 = floor clipped to [0, h-2], fractions
    clipped to [0, 1] (so out-of-range coordinates saturate at the
    border), taps gathered in the source dtype and each converted to f32
    on its own, combined in p00..p11 order."""
    b, h, w, c = imgs.shape
    shape = rows.shape
    r0 = torch.clamp(torch.floor(rows), 0, h - 2)
    c0 = torch.clamp(torch.floor(cols), 0, w - 2)
    fr = torch.clamp(rows - r0, 0.0, 1.0).reshape(b, -1, 1)
    fc = torch.clamp(cols - c0, 0.0, 1.0).reshape(b, -1, 1)
    base = (r0.to(torch.int64) * w + c0.to(torch.int64)).reshape(b, -1, 1)
    flat = imgs.reshape(b, h * w, c)

    def tap(offset):
        idx = (base + offset).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).to(torch.float32)

    p00, p01, p10, p11 = tap(0), tap(1), tap(w), tap(w + 1)
    top = p00 * (1 - fc) + p01 * fc
    bot = p10 * (1 - fc) + p11 * fc
    out = top * (1 - fr) + bot * fr
    return out.reshape(*shape, c)


def nearest_gather(imgs, rows, cols):
    """Sample `imgs` (B,H,W,K) at coordinates, nearest, edge-clamped
    (resample.py:86-91) -> (B, ..., K) in the source dtype."""
    b, h, w, k = imgs.shape
    shape = rows.shape
    r = torch.clamp(torch.round(rows).to(torch.int32), 0, h - 1)
    c = torch.clamp(torch.round(cols).to(torch.int32), 0, w - 1)
    idx = (r.to(torch.int64) * w + c).reshape(b, -1, 1).expand(-1, -1, k)
    return torch.gather(imgs.reshape(b, h * w, k), 1, idx).reshape(*shape, k)


@functools.lru_cache(maxsize=None)
def _reflect_tap_matrices(size, ktaps, device):
    """(K, size, size) 0/1 tap matrices of a reflect-padded 1-D conv: tap
    t of output i reads source reflect(i + t - r) (resample.py:94-105).
    Copied to `device` once per (size, ktaps, device): a host-to-device
    copy each step would wait on the device."""
    r = ktaps // 2
    m = np.zeros((ktaps, size, size), np.float32)
    for t in range(ktaps):
        j = np.arange(size) + t - r
        j = np.where(j < 0, -j, j)
        j = np.where(j >= size, 2 * size - 2 - j, j)
        m[t, np.arange(size), j] = 1.0
    return torch.as_tensor(m, device=device)


def separable_gaussian_blur(imgs, kernels):
    """Reflect-padded separable blur (resample.py:108-123).
    imgs (B,H,W,C) float32, kernels (B,K) normalised 1-D kernels."""
    b, h, w, c = imgs.shape
    assert h == w, "square images expected"
    taps = _reflect_tap_matrices(h, kernels.shape[1], imgs.device)
    m = torch.einsum("bt,tij->bij", kernels, taps)
    rows = torch.matmul(m, imgs.reshape(b, h, w * c)).reshape(b, h, w, c)
    return torch.einsum("bjw,biwc->bijc", m, rows)


def gaussian_kernel(sigma, radius):
    """exp(-x^2 / (2 sigma^2)) on [-radius, radius], normalised
    (resample.py:126-131). sigma (B,) -> (B, 2*radius+1)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-torch.square(x) / (2.0 * sigma[:, None] * sigma[:, None]))
    return k / torch.sum(k, dim=1, keepdim=True)
