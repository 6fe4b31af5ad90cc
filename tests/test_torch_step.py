"""The slice as a whole: one UST-RUN train step of the port against the JAX
package's step on the CPU, float32, for fundus (multilabel, 3 channels)
and BUSI (softmax, 1 channel).

The RNG streams of the two frameworks differ, so the JAX step's own
`build_inputs` dict and the teacher input it made (both under jax.jit,
the program the JAX step runs, which keeps this file within its time) go
through the port: the port's teacher forward (which folds the EMA
model's BN statistics), `loss_terms`, backward and `apply_update`, with
the weights carried by ust_run_tpu_torch.convert. Compared:
  * total loss and the four terms at rtol 1e-5;
  * parameter gradients at rtol 1e-3 in norm, per tensor. Two float32
    effects make an elementwise bound fragile at these shapes (2-image
    BN groups, 2x2 at the bottom level): a ReLU input within rounding of
    0 can resolve differently in the two forwards (see
    test_torch_unet_grads.py), and BN's backward over 8 values per
    statistic amplifies rounding. The seeds are drawn so that no ReLU
    decision flips; measured at them, the port is within 8e-6 (norm) of
    an independent float64 UNet built on F.batch_norm, and the JAX
    gradients within 1e-4 of it, so port and JAX differ by up to 1e-4;
  * new parameters, EMA parameters, student and EMA BN statistics at
    1e-5 absolute;
  * queue, choice_th and the LQ carry after the step (exact for the
    discrete fields, 1e-5 for images).
The state starts at step 1 with one valid queue entry and a valid LQ
carry, so the cut pool, FDA, EMA (alpha 0.5) and queue paths all run;
BUSI runs at epoch 1 with choice_th 2.0 (queue refresh), fundus at
epoch 0 (forced hardness, threshold increase).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from torch_parity import np_tree, random_unet_variables
from ust_run_tpu.models import UNet as JaxUNet
from ust_run_tpu.semisup.state import (CurriculumQueue, LQCarry, TrainState,
                                       make_optimizer)
from ust_run_tpu.semisup.step import HyperParams as JaxHP
from ust_run_tpu.semisup.step import make_step_parts
from ust_run_tpu_torch.convert import unet_state_dict_from_jax
from ust_run_tpu_torch.semisup import state as pstate
from ust_run_tpu_torch.semisup import step as pstep

S, N_CORPUS = 32, 6


def _hp(dataset):
    fundus = dataset == "fundus"
    return JaxHP(
        dataset=dataset, patch=S, channels=3 if fundus else 1,
        num_classes=2, multilabel=fundus, n_part=2 if fundus else 1,
        label_bs=2, unlabel_bs=2, queue_len=4, domain_num=2,
        threshold=0.95, cutmix_prob=1.0, LB=0.01, increase=1.0005,
        consistency=1.0, consistency_rampup=200.0, max_iterations=2,
        ema_decay=0.99, base_lr=0.03, min_v=0.5 if fundus else 0.1,
        max_v=1.5 if fundus else 2.0, fillcolor=255 if fundus else 0,
        blur_radius=1)


class _Recorder:
    """Stands in for the JAX UNet in make_step_parts and keeps the input of
    the teacher's 3-group call."""

    def __init__(self, model):
        self.model = model
        self.teacher_in = None

    def apply(self, variables, x, **kw):
        if kw.get("groups") == 3:
            self.teacher_in = x
        return self.model.apply(variables, x, **kw)


def _corpus(hp, r):
    def lab(shape):
        vals = [0, 128, 255] if hp.dataset == "fundus" else [0, 255]
        return r.choice(vals, shape).astype(np.uint8)
    c = hp.channels
    return {"lb_img": r.randint(0, 256, (N_CORPUS, S, S, c)).astype(np.uint8),
            "lb_lab": lab((N_CORPUS, S, S, 1)),
            "ulb_img": r.randint(0, 256, (N_CORPUS, S, S, c)).astype(np.uint8),
            "ulb_lab": lab((N_CORPUS, S, S, 1)),
            "ulb_dc": np.asarray([1, 2] * (N_CORPUS // 2), np.int32)}


def _jax_state(hp, model, r, epoch, choice_th, seed):
    stu = random_unet_variables(model, hp.channels, S, seed=seed + 1)
    tea = random_unet_variables(model, hp.channels, S, seed=seed + 2)
    q = hp.queue_len
    if hp.multilabel:
        pl = (r.uniform(size=(q, S, S, 2)) > 0.5).astype(np.float32)
        gt = (r.uniform(size=(q, S, S, 2)) > 0.5).astype(np.float32)
        conf = (r.uniform(size=(q, S, S, 2)) > 0.3).astype(np.float32)
    else:
        pl = r.randint(0, 2, (q, S, S)).astype(np.int32)
        gt = r.randint(0, 2, (q, S, S)).astype(np.int32)
        conf = (r.uniform(size=(q, S, S, 1)) > 0.3).astype(np.float32)
    img = r.uniform(-1, 1, (q, S, S, hp.channels)).astype(np.float32)
    queue = CurriculumQueue(
        img=img, pl=pl, gt=gt, conf=conf,
        hardness=r.uniform(size=(q,)).astype(np.float32),
        dc=np.asarray([1, 2, 1, 2][:q], np.int32),
        valid=np.asarray([True] + [False] * (q - 1)))
    lq = LQCarry(img=img[:1] * 0.5, pl=pl[1:2], conf=conf[1:2],
                 valid=np.asarray(True))
    tx = make_optimizer(hp.base_lr, hp.max_iterations)
    return TrainState(
        step=np.int32(1), epoch=np.int32(epoch),
        params=stu["params"], batch_stats=stu["batch_stats"],
        ema_params=tea["params"], ema_batch_stats=tea["batch_stats"],
        opt_state=tx.init(stu["params"]), rng=jax.random.PRNGKey(5),
        queue=queue, lq=lq, choice_th=np.float32(choice_th))


def _t(x, dtype=None):
    a = np.array(x)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def _port_state(hp, js):
    ps = pstate.create_train_state(hp, seed=0, device="cpu")
    ps.student.load_state_dict(unet_state_dict_from_jax(
        {"params": js.params, "batch_stats": js.batch_stats}))
    ps.teacher.load_state_dict(unet_state_dict_from_jax(
        {"params": js.ema_params, "batch_stats": js.ema_batch_stats}))
    ps.step, ps.epoch = int(js.step), int(js.epoch)
    ps.queue = pstate.CurriculumQueue(**{
        f.name: _t(getattr(js.queue, f.name))
        for f in dataclasses.fields(pstate.CurriculumQueue)})
    ps.lq = pstate.LQCarry(img=_t(js.lq.img), pl=_t(js.lq.pl),
                           conf=_t(js.lq.conf), valid=_t(js.lq.valid))
    ps.choice_th = _t(js.choice_th)
    return ps


def _sd(params, stats):
    return unet_state_dict_from_jax({"params": np_tree(params),
                                     "batch_stats": np_tree(stats)})


def _assert_sd(module_sd, want_sd, kinds, **tol):
    for name, v in module_sd.items():
        if name.endswith(kinds):
            np.testing.assert_allclose(v.detach().numpy(),
                                       want_sd[name].numpy(), err_msg=name,
                                       **tol)


@pytest.mark.parametrize("dataset,epoch,choice_th,seed", [
    ("fundus", 0, 0.1, 1), ("BUSI", 1, 2.0, 2)])
def test_one_step_matches_jax(dataset, epoch, choice_th, seed):
    jhp = _hp(dataset)
    hp = pstep.HyperParams(**dataclasses.asdict(jhp))
    r = np.random.RandomState(seed)
    model = JaxUNet(n_channels=jhp.channels, n_classes=jhp.num_classes)
    rec = _Recorder(model)
    _, build_inputs, loss_terms = make_step_parts(rec, jhp)
    step_fn, _, _ = make_step_parts(model, jhp)
    data = _corpus(jhp, r)
    idx = {"lb_idx": np.asarray([0, 3], np.int32),
           "ulb_idx": np.asarray([1, 4], np.int32)}
    js = _jax_state(jhp, model, r, epoch, choice_th, seed * 10)
    ps = _port_state(hp, js)

    # ---- JAX: inputs, loss and gradients, then the whole step -----------
    inp, tea_in = jax.jit(
        lambda *a: (build_inputs(*a), rec.teacher_in))(js, data, idx)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        loss_terms, has_aux=True))(js.params, js, inp)
    new_js, _ = jax.jit(step_fn)(js, data, idx)

    # ---- port: the same inputs through teacher, loss, backward, update --
    pstep.teacher_forward(ps.teacher, _t(tea_in))
    keys = ["lb_x_w", "ulb_x_w", "ulb_x_s", "ulb_x_s_ul", "ulb_x_s_lu",
            "lq_s", "lb_mask", "ulb_mask", "ulb_dc", "pseudo_label", "mask",
            "pseudo_label_ul", "mask_ul", "pseudo_label_lu", "mask_lu",
            "pseudo_label_w", "mask_w", "pseudo_label_lq", "mask_lq",
            "lq_valid", "ratio_before", "ratio_after"]
    pinp = {k: _t(inp[k]) for k in keys}
    pinp["cons_w"] = float(np.asarray(inp["cons_w"]))
    ps.optimizer.zero_grad()
    loss_t, aux_t = pstep.loss_terms(ps, pinp, hp)
    loss_t.backward()

    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for k in ("sup_loss", "unsup_ul", "unsup_lu", "unsup_s"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    g_sd = _sd(grads_j, js.batch_stats)
    for name, p in ps.student.named_parameters():
        want = g_sd[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - want) / np.linalg.norm(want)
        assert err < 1e-3, (name, err)

    pstep.apply_update(ps, pinp, loss_t, aux_t, hp)

    # ---- state after the step ------------------------------------------
    stu_sd = _sd(new_js.params, new_js.batch_stats)
    tea_sd = _sd(new_js.ema_params, new_js.ema_batch_stats)
    tol = dict(rtol=1e-5, atol=1e-5)
    _assert_sd(ps.student.state_dict(), stu_sd,
               ("weight", "bias", "running_mean", "running_var"), **tol)
    _assert_sd(ps.teacher.state_dict(), tea_sd,
               ("weight", "bias", "running_mean", "running_var"), **tol)
    assert ps.step == int(new_js.step) == 2
    np.testing.assert_allclose(float(ps.choice_th),
                               float(new_js.choice_th), rtol=1e-6)
    for f in ("valid", "dc", "pl", "gt", "conf"):
        np.testing.assert_array_equal(
            getattr(ps.queue, f).numpy(),
            np.asarray(getattr(new_js.queue, f)), err_msg=f)
    np.testing.assert_allclose(ps.queue.img.numpy(),
                               np.asarray(new_js.queue.img), **tol)
    np.testing.assert_allclose(ps.queue.hardness.numpy(),
                               np.asarray(new_js.queue.hardness), **tol)
    assert bool(ps.lq.valid) and bool(new_js.lq.valid)
    np.testing.assert_array_equal(ps.lq.pl.numpy(), np.asarray(new_js.lq.pl))
    np.testing.assert_array_equal(ps.lq.conf.numpy(),
                                  np.asarray(new_js.lq.conf))
    np.testing.assert_allclose(ps.lq.img.numpy(), np.asarray(new_js.lq.img),
                               **tol)
    if dataset == "BUSI":       # every sample simple: the queue refreshed
        assert int(ps.queue.valid.sum()) == 3
