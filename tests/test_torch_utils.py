"""The port's losses, metrics, ramps and LR schedule against the JAX
package on random inputs made with numpy (CPU, float32, 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.semisup.state import make_optimizer
from ust_run_tpu.utils import losses as JL
from ust_run_tpu.utils import metrics as JM
from ust_run_tpu.utils import ramps as JR
from ust_run_tpu_torch.semisup.state import lr_at
from ust_run_tpu_torch.utils import losses as L
from ust_run_tpu_torch.utils import metrics as M
from ust_run_tpu_torch.utils import ramps as R

pytestmark = pytest.mark.usefixtures("single_thread")


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("masked", [False, True])
def test_multilabel_losses_match_jax(masked):
    r = np.random.RandomState(0)
    logits = (r.normal(size=(2, 16, 16, 2)) * 3).astype(np.float32)
    target = (r.uniform(size=logits.shape) > 0.5).astype(np.float32)
    mask = (r.uniform(size=logits.shape) > 0.3).astype(np.float32) \
        if masked else None
    t = torch.from_numpy
    _close(L.bce_with_logits(t(logits), t(target)),
           JL.bce_with_logits(logits, target))
    _close(L.dice_loss_multilabel(t(logits), t(target),
                                  None if mask is None else t(mask)),
           JL.dice_loss_multilabel(logits, target, mask))
    _close(L.ce_plus_dice(t(logits), t(target), multilabel=True,
                          n_classes=2, mask=None if mask is None
                          else t(mask)),
           JL.ce_plus_dice(logits, target, multilabel=True, n_classes=2,
                           mask=mask))


@pytest.mark.parametrize("n_classes,masked", [(2, False), (4, True)])
def test_multiclass_losses_match_jax(n_classes, masked):
    """Softmax CE as a one-hot contraction, per-class dice with class 0
    unmasked, masked CE mean over all pixels."""
    r = np.random.RandomState(1)
    logits = (r.normal(size=(2, 16, 16, n_classes)) * 3).astype(np.float32)
    target = r.randint(0, n_classes, (2, 16, 16))
    mask = (r.uniform(size=(2, 16, 16, 1)) > 0.3).astype(np.float32) \
        if masked else None
    t = torch.from_numpy
    _close(L.softmax_ce(t(logits), t(target)),
           JL.softmax_ce(logits, target.astype(np.int32)))
    _close(L.dice_loss_multiclass(t(logits), t(target), n_classes,
                                  None if mask is None else t(mask)),
           JL.dice_loss_multiclass(logits, target, n_classes, mask))
    _close(L.ce_plus_dice(t(logits), t(target), multilabel=False,
                          n_classes=n_classes,
                          mask=None if mask is None else t(mask)),
           JL.ce_plus_dice(logits, target, multilabel=False,
                           n_classes=n_classes, mask=mask))
    # out-of-range targets give a CE of 0, as in the JAX one-hot form
    bad = np.full((1, 2, 2), n_classes)
    _close(L.softmax_ce(t(logits[:1, :2, :2]), t(bad)),
           JL.softmax_ce(logits[:1, :2, :2], bad.astype(np.int32)))


@pytest.mark.parametrize("n_part", [1, 2, 3])
def test_dice_per_part_matches_jax(n_part):
    """+1.0/1.001 smoothing, empty-with-empty gives 0."""
    r = np.random.RandomState(2)
    if n_part == 2:
        shape, hi = (4, 12, 12, 2), 2
    else:
        shape, hi = (4, 12, 12), 2 if n_part == 1 else 4
    pred = r.randint(0, hi, shape)
    target = r.randint(0, hi, shape)
    pred[0] = 0
    target[0] = 0          # both empty -> 0
    got = M.dice_per_part(torch.from_numpy(pred), torch.from_numpy(target),
                          n_part)
    want = JM.dice_per_part_jax(jnp.asarray(pred), jnp.asarray(target),
                                n_part)
    _close(got, want)
    assert float(got[0, 0]) == 0.0


def test_consistency_weight_staircase_matches_jax():
    for it in (0, 1, 149, 150, 151, 2999, 15000, 29999, 30000, 40000):
        for max_it, ramp in ((30000, 200.0), (60000, 200.0), (100, 200.0)):
            want = JR.consistency_weight(1.0, jnp.float32(it), max_it, ramp)
            _close(R.consistency_weight(1.0, it, max_it, ramp), want)


def test_sgd_with_poly_lr_matches_jax_optimizer():
    """torch SGD(momentum 0.9, wd 1e-4) with lr_at set before each update
    follows the JAX package's optax chain over several steps."""
    import optax

    base, max_it = 0.03, 10
    r = np.random.RandomState(3)
    p0 = r.normal(size=(5,)).astype(np.float32)
    grads = r.normal(size=(6, 5)).astype(np.float32)
    tx = make_optimizer(base, max_it)
    p_j, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p_t = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([p_t], lr=base, momentum=0.9, weight_decay=1e-4)
    for k, g in enumerate(grads):
        upd, st = tx.update(jnp.asarray(g), st, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for group in opt.param_groups:
            group["lr"] = lr_at(k, base, max_it)
        p_t.grad = torch.from_numpy(g.copy())
        opt.step()
        _close(p_t.detach(), p_j)
