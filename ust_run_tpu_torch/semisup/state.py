"""Train state (port of ust_run_tpu/semisup/state.py).

The curriculum keeps the JAX package's fixed shapes, so the step never
branches on a device value:
  * the queue is a capacity-`queue_len` buffer with a validity mask,
    valid entries compacted to the front (insertion = prepend + truncate);
  * the LQ carry is a one-slot buffer with a validity flag, reset at every
    epoch boundary (train.py:576).
The step and epoch counters live on the host. Randomness comes from two
explicit generators: `generator` on the state's device for per-sample
draws, and the CPU `host_generator` for the RNG kernel's seeds and the
CutMix boxes.
"""

import dataclasses
from typing import Any

import numpy as np
import torch

from ust_run_tpu_torch.models.unet import UNet


@dataclasses.dataclass
class CurriculumQueue:
    img: Any        # (Q,S,S,C) f32 normalised weak images (simple_ulb)
    pl: Any         # (Q,S,S,2) f32 (fundus) | (Q,S,S) i64  (cor_pl)
    gt: Any         # same shape as pl: decoded true masks (cor_gt)
    conf: Any       # (Q,S,S,2) | (Q,S,S,1) f32 teacher conf masks
    hardness: Any   # (Q,) f32
    dc: Any         # (Q,) i64
    valid: Any      # (Q,) bool

    @property
    def count(self):
        return torch.sum(self.valid.to(torch.int64))

    def fields(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class LQCarry:
    img: Any        # (1,S,S,C)
    pl: Any         # (1,S,S,2) | (1,S,S)
    conf: Any       # (1,S,S,2) | (1,S,S,1)
    valid: Any      # () bool


@dataclasses.dataclass
class TrainState:
    step: int                    # iter_num
    epoch: int                   # epoch_num (hardness forcing)
    student: UNet
    teacher: UNet
    optimizer: torch.optim.SGD
    queue: CurriculumQueue
    lq: LQCarry
    choice_th: Any               # () f32 tensor, init 0.1 (train.py:561)
    generator: torch.Generator
    host_generator: torch.Generator


def _pl_shapes(q, s, multilabel, device):
    if multilabel:
        pl = torch.zeros((q, s, s, 2), device=device)
        conf = torch.zeros((q, s, s, 2), device=device)
    else:
        pl = torch.zeros((q, s, s), dtype=torch.int64, device=device)
        conf = torch.zeros((q, s, s, 1), device=device)
    return pl, conf


def make_optimizer(params, base_lr):
    """torch SGD(momentum=0.9, wd=1e-4) over all parameters (train.py:512);
    `lr_at` sets the learning rate before each update."""
    return torch.optim.SGD(params, lr=base_lr, momentum=0.9,
                           weight_decay=1e-4)


def lr_at(step, base_lr, max_iterations):
    """Poly schedule applied AFTER each reference step (train.py:854-856),
    so update k uses base*(1 - max(k-1, 0)/max)^0.9 (state.py:69-81);
    float32 like the JAX schedule."""
    eff = np.float32(max(step - 1, 0))
    return float(np.float32(base_lr) * (np.float32(1.0) - eff
                                        / np.float32(max_iterations))
                 ** np.float32(0.9))


def build_unet(hp, generator, amp=False):
    return UNet(hp.channels, hp.num_classes, amp=amp).init_weights_(generator)


def create_train_state(hp, seed, device, amp=False):
    """Student and teacher with independent draws (the reference builds two
    fresh models, train.py:496-506; the first EMA update, alpha=0, snaps
    the teacher to the student). Weights are drawn on the CPU, so a seed
    gives the same model on every device."""
    init = torch.Generator().manual_seed(seed)
    student = build_unet(hp, init, amp).to(
        device, memory_format=torch.channels_last)
    teacher = build_unet(hp, init, amp).to(
        device, memory_format=torch.channels_last)
    for p in teacher.parameters():
        p.requires_grad_(False)
    student.train()
    teacher.train()
    q, s = hp.queue_len, hp.patch
    pl, conf = _pl_shapes(q, s, hp.multilabel, device)
    gt, _ = _pl_shapes(q, s, hp.multilabel, device)
    pl1, conf1 = _pl_shapes(1, s, hp.multilabel, device)
    queue = CurriculumQueue(
        img=torch.zeros((q, s, s, hp.channels), device=device),
        pl=pl, gt=gt, conf=conf,
        hardness=torch.zeros((q,), device=device),
        dc=torch.zeros((q,), dtype=torch.int64, device=device),
        valid=torch.zeros((q,), dtype=torch.bool, device=device))
    lq = LQCarry(img=torch.zeros((1, s, s, hp.channels), device=device),
                 pl=pl1, conf=conf1,
                 valid=torch.zeros((), dtype=torch.bool, device=device))
    return TrainState(
        step=0, epoch=0, student=student, teacher=teacher,
        optimizer=make_optimizer(student.parameters(), hp.base_lr),
        queue=queue, lq=lq,
        choice_th=torch.tensor(0.1, dtype=torch.float32, device=device),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
        host_generator=torch.Generator().manual_seed(seed + 2))


def reset_epoch(state, epoch):
    """Epoch boundary: the LQ carry is re-Noned (train.py:576) and the
    epoch feeds the hardness forcing (train.py:711-713)."""
    state.epoch = epoch
    state.lq.valid = torch.zeros_like(state.lq.valid)
    return state
