"""The port's train step on 2 ranks against the JAX step, on the CPU,
float32, for fundus (multilabel, 3 channels); BUSI (softmax, 1 channel)
is in test_torch_parallel_jax_busi.py, so that each file's JAX compile
stays well within a minute.

As in tests/test_torch_step.py, the JAX step's own `build_inputs` dict and
the teacher input it made go through the port, here on 2 Gloo ranks
(tests/torch_dist.py): each rank runs its slice of the teacher's 3 groups
(their BN statistics synchronised) and of the student's 6 groups (batch
2+2: one sample of each group of 2 per rank, the LQ sample on rank 0),
the loss from the ranks' partial sums, the backward and `apply_update`
with the gradients summed over the ranks. Against the JAX step, at the
bars of test_torch_step.py (those the single-process port meets): loss
and terms at rtol 1e-5, the summed gradients at rtol 1e-3 in norm, per
tensor. The state after the step (new and EMA parameters, both models'
BN statistics, queue, choice_th, LQ carry) against the single-process
port fed the same way, which test_torch_step.py holds to the JAX step's:
parameters and statistics at 1e-5, the discrete fields exact, choice_th
at rtol 1e-6. (Compiling the JAX step as a whole as well would double
this file's time.) The replicas are bit-equal.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import torch_dist as td
from test_torch_step import (_Recorder, _corpus, _hp, _jax_state,
                             _port_state, _sd, _t)
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.models import UNet as JaxUNet
from ust_run_tpu.semisup.step import make_step_parts
from ust_run_tpu_torch.semisup import step as pstep

pytestmark = pytest.mark.usefixtures("single_thread")


def test_fundus_step_on_two_ranks_matches_jax(tmp_path):
    check_two_ranks_against_jax(tmp_path, "fundus", 0, 0.1, 1)


@functools.lru_cache(maxsize=None)
def jax_step(dataset, epoch, choice_th, seed):
    """The JAX step's inputs and results from the state test_torch_step.py
    draws: (port HyperParams, the port's state payload, the teacher input,
    the port's input dict, the JAX loss, its terms, its gradients, the JAX
    state)."""
    jhp = _hp(dataset)
    hp = pstep.HyperParams(**dataclasses.asdict(jhp))
    r = np.random.RandomState(seed)
    model = JaxUNet(n_channels=jhp.channels, n_classes=jhp.num_classes)
    rec = _Recorder(model)
    _, build_inputs, loss_terms = make_step_parts(rec, jhp)
    data = _corpus(jhp, r)
    idx = {"lb_idx": np.asarray([0, 3], np.int32),
           "ulb_idx": np.asarray([1, 4], np.int32)}
    js = _jax_state(jhp, model, r, epoch, choice_th, seed * 10)
    ps = _port_state(hp, js)

    inp, tea_in = jax.jit(
        lambda *a: (build_inputs(*a), rec.teacher_in))(js, data, idx)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        loss_terms, has_aux=True))(js.params, js, inp)

    keys = ["lb_x_w", "ulb_x_w", "ulb_x_s", "ulb_x_s_ul", "ulb_x_s_lu",
            "lq_s", "lb_mask", "ulb_mask", "ulb_dc", "pseudo_label", "mask",
            "pseudo_label_ul", "mask_ul", "pseudo_label_lu", "mask_lu",
            "pseudo_label_w", "mask_w", "pseudo_label_lq", "mask_lq",
            "lq_valid", "ratio_before", "ratio_after"]
    pinp = {k: _t(inp[k]) for k in keys}
    pinp["cons_w"] = float(np.asarray(inp["cons_w"]))
    return (hp, td.state_payload(ps), _t(tea_in), pinp, loss_j, aux_j,
            grads_j, js)


def check_two_ranks_against_jax(tmp_path, dataset, epoch, choice_th, seed,
                                world=2, spatial=1):
    """One step of `dataset` from the state test_torch_step.py draws at
    `epoch`, `choice_th` and `seed`, on `world` ranks laid out as
    (world // spatial) x spatial, with the bars of the module
    docstring."""
    hp, payload, tea_in, pinp, loss_j, aux_j, grads_j, js = jax_step(
        dataset, epoch, choice_th, seed)
    args = (hp, payload, tea_in, pinp)
    res = td.run_ranks(tmp_path, world, td.run_fed_step, *args,
                       spatial=spatial)
    assert [x["replica_diff"] for x in res] == [0.0] * world
    got = res[0]
    with td.one_thread():
        one = td.run_fed_step(None, *args)

    np.testing.assert_allclose(float(got["loss"]), float(loss_j), rtol=1e-5)
    for k in ("sup_loss", "unsup_ul", "unsup_lu", "unsup_s"):
        np.testing.assert_allclose(float(got["terms"][k]), float(aux_j[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    g_sd = _sd(grads_j, js.batch_stats)
    for name, g in got["grads"].items():
        want = g_sd[name].numpy()
        err = np.linalg.norm(g.numpy() - want) / np.linalg.norm(want)
        assert err < 1e-3, (name, err)

    st, want = got["state"], one["state"]
    assert st.keys() == want.keys()
    for k, v in st.items():
        if k.startswith(("queue.", "lq.")) and not v.is_floating_point() \
                or "num_batches" in k:
            assert torch.equal(v, want[k]), k
        elif k == "choice_th":
            torch.testing.assert_close(v, want[k], rtol=1e-6, atol=0)
        else:
            torch.testing.assert_close(v, want[k], rtol=0, atol=1e-5, msg=k)
    assert bool(st["lq.valid"])
    if dataset == "BUSI":       # every sample simple: the queue refreshed
        assert int(st["queue.valid"].sum()) == 3
