"""Plain data ops of the SSL step: Philox fields, resampling, weak and
strong augmentation, FDA, CutMix boxes and the schedules.

Frozen copies (see `benchmarks/reference/__init__.py` for the commit):
ust_run_tpu_torch/ops/rng.py (the plain Philox, the key draw),
ops/resample.py, ops/augment.py, ops/fda.py, ops/cutmix.py,
utils/ramps.py and semisup/state.py:lr_at, semisup/step.py:ema_alpha.
Only the plain versions are kept: the fields come from PyTorch integer
arithmetic, never from a kernel, on whatever device the tensors live.
"""

import functools
import math

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------- Philox
def _mulhilo(m, x):
    p1 = m * (x >> 16)
    p0 = m * (x & 0xFFFF)
    t = ((p1 & 0xFFFF) << 16) + p0
    lo = t & _MASK32
    hi = ((p1 >> 16) + (t >> 32)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    for r in range(10):
        if r > 0:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def split_seed(seed):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK32, seed >> 32


def uniform_fields(n, size, seed, device):
    """(n, size, size) float32 U[0,1) on a 2^-24 grid: Philox4x32-10 of
    counter (quad, field, 0, 0) under the 64-bit `seed`."""
    k0, k1 = split_seed(seed)
    per_field = size * size
    quads = (per_field + 3) // 4
    q = torch.arange(quads, dtype=torch.int64, device=device)[None, :]
    f = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    c0 = q.expand(n, quads)
    c1 = f.expand(n, quads)
    zero = torch.zeros_like(c0)
    words = torch.stack(philox4x32_10(c0, c1, zero, zero, k0, k1), dim=-1)
    words = words.reshape(n, 4 * quads)[:, :per_field]
    u = (words >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.reshape(n, size, size)


def draw_seed(generator):
    """A 63-bit seed from a CPU torch.Generator."""
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))


# ------------------------------------------------------------ resampling
def bilinear_gather(imgs, rows, cols):
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
    b, h, w, k = imgs.shape
    shape = rows.shape
    r = torch.clamp(torch.round(rows).to(torch.int32), 0, h - 1)
    c = torch.clamp(torch.round(cols).to(torch.int32), 0, w - 1)
    idx = (r.to(torch.int64) * w + c).reshape(b, -1, 1).expand(-1, -1, k)
    return torch.gather(imgs.reshape(b, h * w, k), 1, idx).reshape(*shape, k)


@functools.lru_cache(maxsize=None)
def _reflect_taps(size, ktaps, device):
    r = ktaps // 2
    m = np.zeros((ktaps, size, size), np.float32)
    for t in range(ktaps):
        j = np.arange(size) + t - r
        j = np.where(j < 0, -j, j)
        j = np.where(j >= size, 2 * size - 2 - j, j)
        m[t, np.arange(size), j] = 1.0
    return torch.as_tensor(m, device=device)


def separable_gaussian_blur(imgs, kernels):
    b, h, w, c = imgs.shape
    taps = _reflect_taps(h, kernels.shape[1], imgs.device)
    m = torch.einsum("bt,tij->bij", kernels, taps)
    rows = torch.matmul(m, imgs.reshape(b, h, w * c)).reshape(b, h, w, c)
    return torch.einsum("bjw,biwc->bijc", m, rows)


def gaussian_kernel(sigma, radius):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-torch.square(x) / (2.0 * sigma[:, None] * sigma[:, None]))
    return k / torch.sum(k, dim=1, keepdim=True)


# ---------------------------------------------------------- augmentation
def _gauss_band_matrix(size, sigma):
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
    return torch.as_tensor(_gauss_band_matrix(size, 0.08 * size),
                           device=device)


def weak_draws(n, generator, device):
    u = torch.rand((8, n), generator=generator, device=device)
    deg = torch.randint(-20, 21, (n,), generator=generator, device=device)
    return dict(do_scale=u[0] > 0.5, scale_w=1.0 + 0.5 * u[1],
                scale_h=1.0 + 0.5 * u[2], u_x=u[3], u_y=u[4],
                do_rot=u[5] > 0.5, deg=deg.to(torch.float32),
                do_flip=u[6] > 0.5, do_el=u[7] > 0.5)


def weak_augment(imgs, masks, *, size, fillcolor, generator, seed):
    """RandomScaleCrop -> RandomScaleRotate -> flip -> elastic as one
    coordinate map per image; 2n Philox fields of `seed`, smoothed."""
    n = imgs.shape[0]
    dev = imgs.device
    masks = masks.to(torch.float32)
    raw = uniform_fields(2 * n, size, seed, dev) * 2.0 - 1.0
    m = _smoothing_matrix(size, dev)
    sm = torch.matmul(torch.matmul(m, raw), m.T)
    alpha = 2.0 * size
    draws = weak_draws(n, generator, dev)
    dx, dy = sm[:n] * alpha, sm[n:] * alpha

    s = size
    sf = float(s)

    def col(v):
        return v[:, None, None]

    do_scale = col(draws["do_scale"])
    w = torch.where(do_scale, torch.floor(col(draws["scale_w"]) * sf), sf)
    h = torch.where(do_scale, torch.floor(col(draws["scale_h"]) * sf), sf)
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


def strong_augment(imgs, *, min_v, max_v, blur_radius, generator):
    """Brightness -> Contrast -> GaussianBlur with uint8 rounding."""
    u = torch.rand((3, imgs.shape[0]), generator=generator,
                   device=imgs.device)

    def col(v):
        return v[:, None, None, None]

    v1 = min_v + (max_v - min_v) * col(u[0])
    imgs = torch.round(torch.clamp(imgs * v1, 0.0, 255.0))
    v2 = min_v + (max_v - min_v) * col(u[1])
    if imgs.shape[-1] == 3:
        gray = torch.floor((imgs[..., 0] * 299 + imgs[..., 1] * 587 +
                            imgs[..., 2] * 114) / 1000.0)
    else:
        gray = imgs[..., 0]
    mean = col(torch.floor(torch.mean(gray, dim=(1, 2)) + 0.5))
    imgs = torch.round(torch.clamp(mean + v2 * (imgs - mean), 0.0, 255.0))
    kern = gaussian_kernel(0.1 + 1.9 * u[2], blur_radius)
    imgs = separable_gaussian_blur(imgs, kern)
    return torch.round(torch.clamp(imgs, 0.0, 255.0))


def normalize(img):
    return img / 127.5 - 1.0


def denormalize(img):
    return (img + 1.0) * 127.5


def blur_radius_for(patch_size):
    return int(0.1 * patch_size) // 2


# ------------------------------------------------------------------- FDA
def fda(src_imgs, trg_imgs, degree, L, *, generator):
    """Each src image restyled toward the amplitude spectrum of the
    matching trg image, ratio ~ U(0, degree), clipped to [0, 255]."""
    ratios = torch.rand((src_imgs.shape[0],), generator=generator,
                        device=src_imgs.device) * degree
    amp_trg = torch.abs(torch.fft.fft2(trg_imgs, dim=(-3, -2)))
    h, w = src_imgs.shape[-3], src_imgs.shape[-2]
    b = int(min(h, w) * L)
    fft_src = torch.fft.fft2(src_imgs, dim=(-3, -2))
    a_src = torch.fft.fftshift(torch.abs(fft_src), dim=(-3, -2))
    a_trg = torch.fft.fftshift(amp_trg, dim=(-3, -2))
    c_h, c_w = h // 2, w // 2
    h1, h2 = c_h - b, c_h + b + 1
    w1, w2 = c_w - b, c_w + b + 1
    r = ratios[:, None, None, None]
    block = a_src[..., h1:h2, w1:w2, :] * (1 - r) \
        + a_trg[..., h1:h2, w1:w2, :] * r
    a_src = a_src.clone()
    a_src[..., h1:h2, w1:w2, :] = block
    amp_new = torch.fft.ifftshift(a_src, dim=(-3, -2))
    fft_new = torch.polar(amp_new, torch.angle(fft_src))
    out = torch.real(torch.fft.ifft2(fft_new, dim=(-3, -2)))
    return torch.clamp(out, 0.0, 255.0)


# ---------------------------------------------------------------- CutMix
class HostDraws:
    """Scalar draws from a CPU torch.Generator, in float32."""

    def __init__(self, generator):
        self.generator = generator

    def uniform(self, lo=0.0, hi=1.0):
        u = np.float32(torch.rand((), generator=self.generator))
        return np.float32(lo) + np.float32(hi - lo) * u

    def randint(self, lo, hi):
        return int(torch.randint(lo, hi, (), generator=self.generator))


def cutmix_box_params(draws, size, p=0.5, size_min=0.02, size_max=0.4,
                      ratio_1=0.3, ratio_2=1 / 0.3):
    """(y, x, h, w) of one rejection-sampled box, zeros when skipped."""
    skip = draws.uniform() > p
    area = draws.uniform(size_min, size_max) * np.float32(size) \
        * np.float32(size)
    while True:
        ratio = draws.uniform(ratio_1, ratio_2)
        w = int(np.floor(np.sqrt(np.float32(area / ratio))))
        h = int(np.floor(np.sqrt(np.float32(area * ratio))))
        x = draws.randint(0, size)
        y = draws.randint(0, size)
        if x + w <= size and y + h <= size:
            break
    return (0, 0, 0, 0) if skip else (y, x, h, w)


def box_masks(size, boxes):
    rows = torch.arange(size, device=boxes.device)[None, :, None]
    cols = torch.arange(size, device=boxes.device)[None, None, :]
    y, x, h, w = (boxes[:, i, None, None] for i in range(4))
    return ((rows >= y) & (rows < y + h) & (cols >= x) &
            (cols < x + w)).to(torch.float32)


def all_cover_box(region, fallback):
    """Bounding box mask of the nonzero region, else the fallback box."""
    s = region.shape[0]
    nz = region > 0
    rows = nz.any(dim=1).to(torch.int32)
    cols = nz.any(dim=0).to(torch.int32)
    y1 = torch.argmax(rows)
    y2 = s - 1 - torch.argmax(torch.flip(rows, [0]))
    x1 = torch.argmax(cols)
    x2 = s - 1 - torch.argmax(torch.flip(cols, [0]))
    bbox = torch.stack([y1, x1, y2 - y1 + 1, x2 - x1 + 1])
    box = torch.where(nz.any(), bbox, fallback.to(bbox.dtype))
    return box_masks(s, box[None])[0]


# ------------------------------------------------------------- schedules
def sigmoid_rampup(current, rampup_length):
    if rampup_length == 0:
        return np.float32(1.0)
    current = np.clip(np.float32(current), np.float32(0.0),
                      np.float32(rampup_length))
    phase = np.float32(1.0) - current / np.float32(rampup_length)
    return np.float32(np.exp(np.float32(-5.0) * phase * phase))


def consistency_weight(consistency, iter_num, max_iterations, rampup_length):
    step = np.floor(np.float32(iter_num)
                    / np.float32(max_iterations / rampup_length))
    return np.float32(np.float32(consistency)
                      * sigmoid_rampup(step, rampup_length))


def lr_at(step, base_lr, max_iterations):
    """Poly rate of update `step`: base * (1 - max(step-1, 0)/max)^0.9."""
    eff = np.float32(max(step - 1, 0))
    return np.float32(np.float32(base_lr) * (np.float32(1.0) - eff
                                             / np.float32(max_iterations))
                      ** np.float32(0.9))


def ema_alpha(step, ema_decay):
    return min(np.float32(1.0) - np.float32(1.0) / (np.float32(step) + 1),
               np.float32(ema_decay))
