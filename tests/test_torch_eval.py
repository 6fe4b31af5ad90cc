"""ust_run_tpu_torch's evaluation against the JAX package's, on the CPU,
float32:

  * `engine.evaluator.Evaluator.run` against the JAX `Evaluator.run` with
    the same UNet weights (drawn with numpy from a seed, bridged by
    `convert.unet_state_dict_from_jax`) on a synthetic corpus at patch 32,
    for fundus (multilabel, two parts), prostate (softmax, one part) and
    MNMS (softmax, three parts, the stacked branch), each with a padded
    tail batch. The out conv's biases are shifted by the mean logit of
    each class over the test images, so that every part's predicted mask
    is neither empty nor full and the boundary metrics are non-trivial.
    The predicted masks must be identical, then dice, dc, jc, hd95, asd
    and the loss, per domain and overall, agree to 1e-5. The seeds are
    chosen so that no pixel sits within ten times the largest logit
    difference between the two frameworks of the decision threshold
    (|logit| for sigmoid, the top-two gap for softmax); the test asserts
    that margin, so float32 rounding cannot flip a pixel.
  * the port's native boundary engine (native/boundary.cc through its own
    loader) against its scipy version and against the JAX package's
    `boundary_native.boundary_metrics`.
"""

import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import unet_pair
from ust_run_tpu_torch.convert import unet_state_dict_from_jax
from ust_run_tpu.config import TrainConfig as JaxConfig
from ust_run_tpu.data.datasets import SegmentationDataset as JaxDataset
from ust_run_tpu.data.pipeline import TestLoader as JaxLoader
from ust_run_tpu.engine.evaluator import Evaluator as JaxEvaluator
from ust_run_tpu.semisup import HyperParams as JaxHP
from ust_run_tpu.utils import boundary_native as jax_bn
from ust_run_tpu_torch.config import TrainConfig
from ust_run_tpu_torch.data import synthetic
from ust_run_tpu_torch.data.datasets import SegmentationDataset
from ust_run_tpu_torch.data.pipeline import TestLoader
from ust_run_tpu_torch.engine.evaluator import Evaluator
from ust_run_tpu_torch.semisup.step import HyperParams
from ust_run_tpu_torch.utils import boundary as B
from ust_run_tpu_torch.utils import boundary_native as BN
from ust_run_tpu_torch.utils import native_build

SIZE, DOMAINS, BATCH = 32, (1, 2), 2
NUMBER = re.compile(r"-?\d+\.\d+")

# dataset -> (weight seed, data seed), chosen for the threshold margin
CASES = {"fundus": (2, 0), "prostate": (4, 0), "MNMS": (3, 0)}


def _setup(dataset, root):
    wseed, dseed = CASES[dataset]
    # 3 test images per domain: batch 2 leaves a 1-sample padded tail
    synthetic.generate(dataset, root, n_train=2, n_test=3, size=SIZE,
                       seed=dseed)
    kw = dict(dataset=dataset, patch_override=SIZE, data_root=root)
    cfg, jcfg = TrainConfig(**kw).resolve(), JaxConfig(**kw).resolve()
    p, jp = cfg.profile(), jcfg.profile()
    ours = Evaluator(HyperParams.from_config(cfg), [
        TestLoader(SegmentationDataset(dataset, p, root, "test", -1, [d]),
                   BATCH) for d in DOMAINS], list(p.parts), "cpu")
    theirs = JaxEvaluator(None, JaxHP.from_config(jcfg), [
        JaxLoader(JaxDataset(dataset, jp, root, "test", -1, [d]), BATCH)
        for d in DOMAINS], list(jp.parts))
    model, variables, net = unet_pair(p.num_channels, p.num_classes, 0, 0,
                                      SIZE, wseed)
    theirs.model = model
    net.eval()
    with torch.no_grad():
        logits = torch.cat([net(_x(b["image"])) for loader in ours.loaders
                            for b in loader])
    bias = variables["params"]["outc"]["bias"]
    variables["params"]["outc"]["bias"] = (
        bias - logits.mean(dim=(0, 1, 2)).numpy()).astype(np.float32)
    net.load_state_dict(unet_state_dict_from_jax(variables))
    return ours, theirs, variables, net


def _x(img_u8):
    return torch.from_numpy(img_u8).float() / 127.5 - 1.0


def _numbers(records):
    return np.array([float(x) for r in records
                     for x in NUMBER.findall(r.getMessage())])


@pytest.mark.parametrize("dataset", list(CASES))
def test_evaluator_matches_jax(dataset, tmp_path, caplog):
    ours, theirs, variables, net = _setup(dataset, str(tmp_path))
    model = theirs.model
    params, stats = variables["params"], variables["batch_stats"]
    n_batches = 0
    for loader in ours.loaders:
        for batch in loader:
            with torch.no_grad():
                logits = net(_x(batch["image"]))
            jlogits = model.apply(variables, jnp.asarray(_x(batch["image"])
                                                         .numpy()),
                                  train=False)
            diff = np.abs(logits.numpy() - np.asarray(jlogits)).max()
            if ours.hp.multilabel:
                margin = logits.abs().min()
            else:
                top2 = torch.topk(logits, 2, dim=-1).values
                margin = (top2[..., 0] - top2[..., 1]).min()
            assert margin > 10 * diff, "seed puts a pixel on the threshold"
            dice, loss, pred, mask = ours.forward(net, batch["image"],
                                                  batch["label"])
            jd, jl, jpred, jmask = theirs._fwd(params, stats,
                                               jnp.asarray(batch["image"]),
                                               jnp.asarray(batch["label"]))
            np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
            np.testing.assert_allclose(dice.numpy(), np.asarray(jd),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(loss.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=1e-5)
            n_batches += 1
    assert n_batches == 2 * len(DOMAINS)

    with caplog.at_level(logging.INFO):
        caplog.clear()
        got = ours.run(net, 3, ema=False)
        ours_log = list(caplog.records)
        caplog.clear()
        want = theirs.run(params, stats, 3, ema=False)
        theirs_log = list(caplog.records)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the same log lines: the text with the numbers taken out, then the
    # numbers (loss, dice, dc, jc, hd95, asd per domain and overall)
    assert [NUMBER.sub("#", r.getMessage()) for r in ours_log] == \
        [NUMBER.sub("#", r.getMessage()) for r in theirs_log]
    a, b = _numbers(ours_log), _numbers(theirs_log)
    assert a.size == b.size == (len(DOMAINS) + 1) * (1 + 5 * len(got))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert net.training is False          # run() restored the mode it found


def _blob(rng, size=48):
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = rng.randint(10, size - 10, 2)
    r = rng.uniform(4, 12)
    m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return m ^ (m & (rng.rand(size, size) < 0.05))


def test_native_boundary_matches_scipy_and_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        a, b = _blob(rng), _blob(rng)
        ours = BN.boundary_metrics(a, b)
        np.testing.assert_allclose(ours, B.boundary_metrics(a, b),
                                   rtol=0, atol=1e-9)
        assert ours == tuple(jax_bn.boundary_metrics(a, b))
    z = np.zeros((16, 16), bool)
    one = z.copy()
    one[4:8, 4:8] = True
    for p, g in ((z, one), (one, z), (z, z)):
        d, j, h, s = BN.boundary_metrics(p, g)
        assert d == 0.0 and j == 0.0 and np.isnan(h) and np.isnan(s)
        assert np.isnan(B.boundary_metrics(p, g)[2])
    assert BN.boundary_metrics(one, one) == (1.0, 1.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="2-D masks"):
        BN.boundary_metrics(one, one[:8])


def test_native_build_raises_without_compiler(monkeypatch, tmp_path):
    """A failed build raises; there is no quiet scipy fallback."""
    monkeypatch.setattr(native_build, "BUILD", str(tmp_path))
    monkeypatch.setattr(BN, "GXX_FLAGS", ["-O3", "-shared", "-fPIC",
                                          "-DBOUNDARY_BUILD_TEST",
                                          "-include", "no_such_header.h"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        BN.build()
