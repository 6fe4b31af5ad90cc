"""The Unet2D train step on a mesh with a space axis, on the CPU, float32
(the 2 x 2 case runs in test_torch_spatial_zoo_step22.py and
DeepLabV2-R50's in test_torch_spatial_r50_step.py, so that each file's
time stays short).

`--model unet2d` on 1 x 2 and 2 x 2 against the JAX step
(`make_step_parts`), fed as tests/test_torch_step.py feeds it: the JAX
step's `build_inputs` and teacher input through the port's teacher
forward, `loss_terms`, backward and `apply_update` on the ranks. Bars,
tests/test_torch_zoo_step.py's: loss and terms at rtol 1e-5, every
gradient at 1e-3 in norm (a conv bias that a BatchNorm follows, zero but
for rounding, below 1e-5 of the largest entry), the state after the step
at 1e-5 against the single-process port fed alike; the replicas
bit-equal. At 1 x 2 the JAX step runs on `make_mesh(2, spatial=2)`. At
2 x 2 it runs unsharded, which GSPMD must equal: on `make_mesh(4,
spatial=2)` the JAX step on the CPU departs from its own unsharded step
(at seed 2 the loss agrees to 1 ulp, but the first levels' BatchNorm
gradients lie 7.37x their norm off), while make_mesh(2, spatial=2),
(4, 1) and (2, 1) agree with it within 2.1e-5 (`python
tests/torch_spatial_zoo.py jax-step unet2d 2`). Seed 2 is
test_torch_zoo_step.py's flip-free seed, and flips nothing on either
mesh.
"""

import dataclasses
import functools

import jax
import numpy as np
import torch

import torch_dist as td
from test_torch_step import _corpus, _hp, _jax_state, _Recorder, _t
from torch_parity import np_tree
from torch_spatial_zoo import grad_errors
from ust_run_tpu.models import Unet2D as JaxUnet2D
from ust_run_tpu.parallel.mesh import make_mesh
from ust_run_tpu.semisup.step import make_step_parts
from ust_run_tpu_torch.convert import unet2d_state_dict_from_jax
from ust_run_tpu_torch.semisup import state as pstate
from ust_run_tpu_torch.semisup import step as pstep

UNET2D_SEED = 2


def _sd(params, stats):
    return unet2d_state_dict_from_jax({"params": np_tree(params),
                                       "batch_stats": np_tree(stats)})


@functools.lru_cache(maxsize=None)
def jax_unet2d_step(world, seed):
    """The JAX Unet2D step's inputs and results, on make_mesh(2,
    spatial=2) for world 2 and unsharded for world 4 (see the module
    docstring): (port HyperParams, the port's state payload, the teacher
    input, the port's input dict, the JAX loss, its terms, its gradients
    as a port state_dict)."""
    jhp = _hp("fundus")
    hp = pstep.HyperParams(**dataclasses.asdict(jhp))
    r = np.random.RandomState(seed)
    model = JaxUnet2D(c=jhp.channels, num_classes=jhp.num_classes)
    rec = _Recorder(model)
    _, build_inputs, loss_terms = make_step_parts(
        rec, jhp, make_mesh(2, spatial=2) if world == 2 else None)
    data = _corpus(jhp, r)
    idx = {"lb_idx": np.asarray([0, 3], np.int32),
           "ulb_idx": np.asarray([1, 4], np.int32)}
    js = _jax_state(jhp, model, r, 0, 0.1, seed * 10)
    ps = pstate.create_train_state(hp, 0, "cpu", *(
        td.zoo_model("unet2d", hp.channels, hp.num_classes)
        for _ in range(2)))
    ps.student.load_state_dict(_sd(js.params, js.batch_stats))
    ps.teacher.load_state_dict(_sd(js.ema_params, js.ema_batch_stats))
    ps.step, ps.epoch = int(js.step), int(js.epoch)
    ps.queue = pstate.CurriculumQueue(**{
        f.name: _t(getattr(js.queue, f.name))
        for f in dataclasses.fields(pstate.CurriculumQueue)})
    ps.lq = pstate.LQCarry(img=_t(js.lq.img), pl=_t(js.lq.pl),
                           conf=_t(js.lq.conf), valid=_t(js.lq.valid))
    ps.choice_th = _t(js.choice_th)

    inp, tea_in = jax.jit(
        lambda *a: (build_inputs(*a), rec.teacher_in))(js, data, idx)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        loss_terms, has_aux=True))(js.params, js, inp)
    pinp = {k: _t(v) for k, v in inp.items()
            if k not in ("rng_next", "tea_batch_stats", "cons_w")}
    pinp["cons_w"] = float(np.asarray(inp["cons_w"]))
    return (hp, td.state_payload(ps), _t(tea_in), pinp, float(loss_j),
            {k: float(aux_j[k]) for k in ("sup_loss", "unsup_ul",
                                          "unsup_lu", "unsup_s")},
            _sd(grads_j, js.batch_stats))


def check_unet2d_step(tmp_path, world, seed):
    hp, payload, tea_in, pinp, loss_j, aux_j, g_sd = jax_unet2d_step(world,
                                                                     seed)
    args = (hp, payload, tea_in, pinp, "unet2d")
    res = td.run_ranks(tmp_path, world, td.run_fed_step, *args, spatial=2)
    assert [x["replica_diff"] for x in res] == [0.0] * world
    got = res[0]
    np.testing.assert_allclose(float(got["loss"]), loss_j, rtol=1e-5)
    for k, v in aux_j.items():
        np.testing.assert_allclose(float(got["terms"][k]), v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    errs, zero = grad_errors(got["grads"], g_sd)
    worst = max(errs.items(), key=lambda e: e[1])
    assert worst[1] < 1e-3 and zero < 1.0, (worst, zero)
    with td.one_thread():
        one = td.run_fed_step(None, *args)
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
    return worst


def test_unet2d_step_on_1x2_matches_jax_mesh(tmp_path):
    check_unet2d_step(tmp_path, 2, UNET2D_SEED)
