"""CutMix boxes (port of ust_run_tpu/ops/cutmix.py).

`obtain_cutmix_box` (train.py:222-240) rejection-samples a box of area
U(0.02,0.4)*S^2 with aspect ratio U(0.3, 1/0.3) fully inside the image.
The draws do not depend on device data, so the loop runs on the host,
drawing from a CPU torch.Generator: no step waits on the device, and the
loop is exact rather than capped. Only the (y, x, h, w) integers go to
the device, where the masks are built. `all_cover_box` (train.py:242-251)
needs the device's region and stays there, with a host-drawn fallback.
"""

import numpy as np
import torch


class HostDraws:
    """Scalar draws from a CPU torch.Generator, in float32 like the JAX
    package's jax.random.uniform."""

    def __init__(self, generator):
        if generator.device.type != "cpu":
            raise ValueError("HostDraws needs a CPU torch.Generator")
        self.generator = generator

    def uniform(self, lo=0.0, hi=1.0):
        u = np.float32(torch.rand((), generator=self.generator))
        return np.float32(lo) + np.float32(hi - lo) * u

    def randint(self, lo, hi):
        return int(torch.randint(lo, hi, (), generator=self.generator))


def cutmix_box_params(draws, size, p=0.5, size_min=0.02, size_max=0.4,
                      ratio_1=0.3, ratio_2=1 / 0.3):
    """(y, x, h, w) of one box, (0, 0, 0, 0) when skipped (probability
    1 - p). Area drawn once, (ratio, x, y) redrawn until the box fits
    (cutmix.py:26-56)."""
    skip = draws.uniform() > p
    area = draws.uniform(size_min, size_max) * np.float32(size) \
        * np.float32(size)
    while True:
        ratio = draws.uniform(ratio_1, ratio_2)
        w = int(np.floor(np.sqrt(np.float32(area / ratio))))
        h = int(np.floor(np.sqrt(np.float32(area * ratio))))
        x = draws.randint(0, size)           # np.random.randint: [0, S)
        y = draws.randint(0, size)
        if x + w <= size and y + h <= size:
            break
    return (0, 0, 0, 0) if skip else (y, x, h, w)


def box_masks(size, boxes):
    """(n, 4) int (y, x, h, w) tensor -> (n, size, size) float32 {0,1}
    masks, mask[y:y+h, x:x+w] = 1."""
    rows = torch.arange(size, device=boxes.device)[None, :, None]
    cols = torch.arange(size, device=boxes.device)[None, None, :]
    y, x, h, w = (boxes[:, i, None, None] for i in range(4))
    return ((rows >= y) & (rows < y + h) & (cols >= x) &
            (cols < x + w)).to(torch.float32)


def to_device(rows, device):
    """Small host int table -> int64 tensor on `device`, without waiting on
    the device (pinned memory, non-blocking copy)."""
    t = torch.tensor(rows, dtype=torch.int64)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def cutmix_boxes(n, size, p, *, host_generator, device):
    """(n, size, size) independent boxes (train.py:639)."""
    draws = HostDraws(host_generator)
    params = [cutmix_box_params(draws, size, p) for _ in range(n)]
    return box_masks(size, to_device(params, device))


def all_cover_box(region, fallback):
    """Bounding box of the nonzero region, the forced-cutmix `fallback`
    box ((4,) int tensor, y x h w) if the region is empty. region (S,S)."""
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
