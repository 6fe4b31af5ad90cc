"""Batch assembly for training and evaluation.

Replaces the reference's `cycle(DataLoader(shuffle=True, num_workers=2,
drop_last=True))` pattern (train.py:95-105, 490-491). Sampling semantics
match torch's RandomSampler: a fresh permutation each epoch, consecutive
batches, partial trailing batch dropped. Batches are raw uint8 arrays —
augmentation happens on the device inside the train step, so host work per
step is a couple of numpy gathers.
"""

import numpy as np
import torch

from ust_run_tpu_torch.parallel.mesh import shard_slice


class BatchPipeline:
    """Infinite shuffled batch iterator over a SegmentationDataset."""

    def __init__(self, dataset, batch_size, seed=0):
        self.ds = dataset
        self.bs = batch_size
        if len(dataset) < batch_size:
            # torch drop_last would yield nothing; sample with replacement
            # instead so tiny smoke datasets still train.
            self._small = True
        else:
            self._small = False
        self.rng = np.random.RandomState(seed)
        self._order = None
        self._pos = 0

    def _reshuffle(self):
        self._order = self.rng.permutation(len(self.ds))
        self._pos = 0

    def next_indices(self):
        """Sampled indices only — the training path keeps the decoded
        corpus resident in device memory and ships just these."""
        if self._small:
            return self.rng.randint(0, len(self.ds), self.bs)
        if self._order is None or self._pos + self.bs > len(self.ds):
            self._reshuffle()
        idx = self._order[self._pos:self._pos + self.bs]
        self._pos += self.bs
        return np.asarray(idx)

    def state(self):
        """The sampler's position as tensors and numbers (a checkpoint
        entry that loads with torch.load(weights_only=True))."""
        _, keys, pos, has_gauss, gauss = self.rng.get_state()
        return {"keys": torch.from_numpy(keys.astype(np.int64)),
                "pos": int(pos), "has_gauss": int(has_gauss),
                "gauss": float(gauss),
                "order": None if self._order is None
                else torch.from_numpy(np.asarray(self._order, np.int64)),
                "at": self._pos}

    def load_state(self, s):
        self.rng.set_state(("MT19937", s["keys"].numpy().astype(np.uint32),
                            s["pos"], s["has_gauss"], s["gauss"]))
        self._order = None if s["order"] is None else s["order"].numpy()
        self._pos = s["at"]

    def next(self):
        idx = self.next_indices()
        return {
            "image": self.ds.images[idx],
            "label": self.ds.labels[idx],
            "dc": self.ds.dc[idx],
            "names": [self.ds.names[i] for i in idx],
        }


class TestLoader:
    """Sequential fixed-size padded batches over a test dataset.

    The reference evaluates with batch_size=1 (train.py:493); here samples
    are packed into fixed `batch` chunks (padded at the tail, with a
    validity mask) so every forward sees one shape. `rows` (default: all)
    are the dataset indices it visits, in order.
    """

    __test__ = False  # keep pytest from collecting this as a test class

    def __init__(self, dataset, batch, rows=None):
        self.ds = dataset
        self.batch = batch
        self.rows = np.arange(len(dataset)) if rows is None \
            else np.asarray(rows, np.int64)

    def shard(self, rank, world):
        """The loader over this rank's contiguous share of the rows."""
        return TestLoader(self.ds, self.batch,
                          self.rows[shard_slice(len(self.rows), rank, world)])

    def __iter__(self):
        n = len(self.rows)
        for start in range(0, n, self.batch):
            idx = self.rows[start:start + self.batch]
            pad = self.batch - len(idx)
            pidx = np.concatenate([idx, np.zeros(pad, np.int64)]) if pad \
                else idx
            valid = np.concatenate([np.ones(len(idx), bool),
                                    np.zeros(pad, bool)])
            yield {
                "image": self.ds.images[pidx],
                "label": self.ds.labels[pidx],
                "dc": self.ds.dc[pidx],
                "valid": valid,
                "names": [self.ds.names[i] for i in idx],
            }

    def __len__(self):
        return (len(self.rows) + self.batch - 1) // self.batch
