"""Helpers of the `--unroll_steps` tests: a small step configuration, a
corpus and two-model train states made from seeds, and every tensor of a
state for exact comparison. The states hold Unet2Ds of base width 4
(GroupedBatchNorm, the step's group calls): what these tests hold is the
step's plumbing, which no model width changes, and the UNet's fixed
64-1024 widths would make each CPU step cost a second."""

import numpy as np
import torch

from torch_threads import single_thread  # noqa: F401
from ust_run_tpu_torch.models import Unet2D
from ust_run_tpu_torch.semisup import state as pstate
from ust_run_tpu_torch.semisup.step import HyperParams

S, N_CORPUS = 32, 6


def hp_for(dataset, max_iterations=10):
    fundus = dataset == "fundus"
    return HyperParams(
        dataset=dataset, patch=S, channels=3 if fundus else 1,
        num_classes=2, multilabel=fundus, n_part=2 if fundus else 1,
        label_bs=2, unlabel_bs=2, queue_len=4, domain_num=2,
        threshold=0.95, cutmix_prob=1.0, LB=0.01, increase=1.0005,
        consistency=1.0, consistency_rampup=200.0,
        max_iterations=max_iterations, ema_decay=0.99, base_lr=0.03,
        min_v=0.5 if fundus else 0.1, max_v=1.5 if fundus else 2.0,
        fillcolor=255 if fundus else 0, blur_radius=1)


def corpus(hp, seed):
    """uint8 images and labels (fundus: values 0/128/255; BUSI: 0/255)."""
    r = np.random.RandomState(seed)
    levels = [0, 128, 255] if hp.multilabel else [0, 255]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    shape = (N_CORPUS, S, S)
    return {"lb_img": t(r.randint(0, 256, shape + (hp.channels,))
                        .astype(np.uint8)),
            "lb_lab": t(r.choice(levels, shape + (1,)).astype(np.uint8)),
            "ulb_img": t(r.randint(0, 256, shape + (hp.channels,))
                         .astype(np.uint8)),
            "ulb_lab": t(r.choice(levels, shape + (1,)).astype(np.uint8)),
            "ulb_dc": t(r.randint(1, hp.domain_num + 1, N_CORPUS)
                        .astype(np.int32))}


def index_rows(seed, n, hp):
    """n index batches {'lb_idx', 'ulb_idx'}, int64."""
    r = np.random.RandomState(seed)
    return [{"lb_idx": torch.from_numpy(r.randint(0, N_CORPUS, hp.label_bs)),
             "ulb_idx": torch.from_numpy(r.randint(0, N_CORPUS,
                                                   hp.unlabel_bs))}
            for _ in range(n)]


def new_state(hp, seed, choice_th=2.0):
    """A CPU train state, both models drawn from `seed`; `choice_th` 2.0
    makes every sample simple, so the queue fills from the first step."""
    init = torch.Generator().manual_seed(seed)
    models = [Unet2D(c=hp.channels, n=4, num_classes=hp.num_classes)
              .init_weights_(init) for _ in range(2)]
    st = pstate.create_train_state(hp, seed, "cpu", *models)
    st.choice_th.fill_(choice_th)
    return st


def state_tensors(st):
    """{name: tensor} of every tensor a step reads or writes, and the
    generators' states."""
    out = {f"student.{k}": v for k, v in st.student.state_dict().items()}
    out.update({f"teacher.{k}": v for k, v in st.teacher.state_dict().items()})
    out.update({f"momentum.{i}": s["momentum_buffer"] for i, s in
                enumerate(st.optimizer.state.values())})
    out.update({f"queue.{k}": v for k, v in st.queue.fields().items()})
    out.update({f"lq.{k}": v for k, v in st.lq.fields().items()})
    out["choice_th"] = st.choice_th
    out["generator"] = st.generator.get_state()
    out["host_generator"] = st.host_generator.get_state()
    return out


def assert_states_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    diff = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not diff, diff[:10]
    assert (a.step, a.epoch) == (b.step, b.epoch)
