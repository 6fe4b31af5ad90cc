"""Traffic of a training cell: the synthetic corpus on the device and the
stream of index rows the K-step calls consume, all from `--seed`.

The corpus follows the port's bench (ust_run_tpu_torch/bench.py:
make_corpus): uint8 images uniform on [0, 255], label planes drawn from
{0, 128, 255}, every unlabelled image of domain 1. It is drawn on the
device from a torch.Generator in a few large calls. Index rows are drawn
on the host (bench.py: draw_indices): the first `checked_steps` steps take
rows that all differ, the rest draw with replacement.
"""

import numpy as np
import torch

LABEL_VALUES = (0, 128, 255)


def make_corpus(generator, n, size, channels, label_channels, device):
    """{'lb_img', 'lb_lab', 'ulb_img', 'ulb_lab', 'ulb_dc'} on `device`."""
    def images(c):
        return torch.randint(0, 256, (n, size, size, c), generator=generator,
                             device=device, dtype=torch.uint8)

    values = torch.tensor(LABEL_VALUES, dtype=torch.uint8, device=device)

    def labels():
        pick = torch.randint(0, len(LABEL_VALUES),
                             (n, size, size, label_channels),
                             generator=generator, device=device)
        return values[pick]

    return {"lb_img": images(channels), "lb_lab": labels(),
            "ulb_img": images(channels), "ulb_lab": labels(),
            "ulb_dc": torch.ones(n, dtype=torch.int32, device=device)}


class IndexStream:
    """Index rows of the cell: `first(k)` gives k steps whose labelled rows
    all differ and whose unlabelled rows all differ; `draw(k)` gives the
    next k steps, drawn with replacement. Each is {'lb_idx', 'ulb_idx'}
    int64 arrays of shape (k, batch)."""

    def __init__(self, seed, n, label_bs, unlabel_bs):
        self.rng = np.random.default_rng(seed)
        self.n, self.label_bs, self.unlabel_bs = n, label_bs, unlabel_bs

    def first(self, k):
        lb = self.rng.permutation(self.n)[:k * self.label_bs]
        ulb = self.rng.permutation(self.n)[:k * self.unlabel_bs]
        return {"lb_idx": lb.reshape(k, self.label_bs).astype(np.int64),
                "ulb_idx": ulb.reshape(k, self.unlabel_bs).astype(np.int64)}

    def draw(self, k):
        return {"lb_idx": self.rng.integers(0, self.n, (k, self.label_bs),
                                            dtype=np.int64),
                "ulb_idx": self.rng.integers(0, self.n, (k, self.unlabel_bs),
                                             dtype=np.int64)}
