"""tests/torch_paired_run.py at a tiny size (patch 32, one step), from
the port's initial weights carried into the JAX trainer: both trainers
start from the same weights, so their first-layer and per-module BN
statistics agree before the step (rtol 1e-6); both losses are finite
and every recorded input lies in the normalised range [-1, 1] (to 1e-6:
255 / 127.5 - 1 rounds to 1 + 1.2e-7 in float32)."""

import numpy as np

from torch_paired_run import INPUTS, paired_run
from ust_run_tpu_torch.data.synthetic import generate


def test_paired_run_starts_equal(tmp_path):
    root = generate("fundus", str(tmp_path / "data"), n_train=9, n_test=1,
                    size=32, seed=0)
    records = paired_run(root, str(tmp_path), steps=1, patch=32, every=1,
                         init="port")
    assert [r["iter"] for r in records] == [0, 1]
    j, p = records[0]["jax"], records[0]["port"]
    assert list(j["bn"]) == list(p["bn"])
    np.testing.assert_allclose([j["bn"][k] for k in j["bn"]],
                               [p["bn"][k] for k in j["bn"]], rtol=1e-6)
    np.testing.assert_allclose([j["inc"]["mean"], j["inc"]["var"]],
                               [p["inc"]["mean"], p["inc"]["var"]],
                               rtol=1e-6)
    for r in records[:1]:
        for w in ("jax", "port"):
            assert np.isfinite(r[w]["loss"])
            for k in INPUTS:
                s = r[w]["inputs"][k]
                assert -1.0 - 1e-6 <= s["min"] <= s["mean"] <= s["max"] \
                    <= 1.0 + 1e-6, (w, k, s)
