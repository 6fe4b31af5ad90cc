"""Fourier domain adaptation (port of ust_run_tpu/ops/fda.py).

Swap the centre (2b+1)^2 block of the fftshifted amplitude spectrum,
b = floor(min(H,W)*L), blending source and target amplitudes with a
per-sample ratio ~ U(0, degree); recombine with the source phase and take
the real part of the inverse FFT (train.py:158-207). NHWC images.
"""

import torch


def extract_amp(imgs):
    """Amplitude spectrum over the spatial axes of (..., H, W, C)."""
    return torch.abs(torch.fft.fft2(imgs, dim=(-3, -2)))


def _mutate_amp(amp_src, amp_trg, ratio, b):
    """Blend the centred low-frequency block (train.py:166-185).
    ratio broadcasts against (..., H, W, C)."""
    h, w = amp_src.shape[-3], amp_src.shape[-2]
    a_src = torch.fft.fftshift(amp_src, dim=(-3, -2))
    a_trg = torch.fft.fftshift(amp_trg, dim=(-3, -2))
    c_h, c_w = h // 2, w // 2
    h1, h2 = c_h - b, c_h + b + 1
    w1, w2 = c_w - b, c_w + b + 1
    block = a_src[..., h1:h2, w1:w2, :] * (1 - ratio) \
        + a_trg[..., h1:h2, w1:w2, :] * ratio
    a_src = a_src.clone()
    a_src[..., h1:h2, w1:w2, :] = block
    return torch.fft.ifftshift(a_src, dim=(-3, -2))


def source_to_target(src_imgs, amp_trg, ratios, L):
    """(B,H,W,C) images restyled toward target amplitudes; ratios (B,)."""
    h, w = src_imgs.shape[-3], src_imgs.shape[-2]
    b = int(min(h, w) * L)
    fft_src = torch.fft.fft2(src_imgs, dim=(-3, -2))
    amp_new = _mutate_amp(torch.abs(fft_src), amp_trg,
                          ratios[:, None, None, None], b)
    fft_new = torch.polar(amp_new, torch.angle(fft_src))
    return torch.real(torch.fft.ifft2(fft_new, dim=(-3, -2)))


def fda_apply(src_imgs, trg_imgs, ratios, L):
    """Restyle each src image toward the amplitude of the matching trg
    image (train.py:629-636), clipped to [0,255]. Inputs in [0,255]."""
    out = source_to_target(src_imgs, extract_amp(trg_imgs), ratios, L)
    return torch.clamp(out, 0.0, 255.0)


def fda_batch(src_imgs, trg_imgs, degree, L, *, generator):
    """fda_apply with ratios ~ U(0, degree) drawn from `generator`."""
    ratios = torch.rand((src_imgs.shape[0],), generator=generator,
                        device=src_imgs.device) * degree
    return fda_apply(src_imgs, trg_imgs, ratios, L)
