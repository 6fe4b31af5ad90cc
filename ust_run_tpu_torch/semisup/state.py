"""Train state (port of ust_run_tpu/semisup/state.py).

The curriculum keeps the JAX package's fixed shapes, so the step never
branches on a device value:
  * the queue is a capacity-`queue_len` buffer with a validity mask,
    valid entries compacted to the front (insertion = prepend + truncate);
  * the LQ carry is a one-slot buffer with a validity flag, reset at every
    epoch boundary (train.py:576).
The step and epoch counters live on the host. Randomness comes from two
explicit generators: `generator` on the state's device for per-sample
draws, and the CPU `host_generator` for the RNG kernel's keys and the
CutMix boxes.

Every tensor of the state keeps its storage for the state's life: the
step, the epoch reset and `engine/checkpoint.py:restore_state` write into
it, so a CUDA graph of the step captured once (`graph`, semisup/step.py)
reads and writes the live state on every replay.
"""

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from ust_run_tpu_torch.models import DeepLabV2, UNet, Unet2D, transunet


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

    def fields(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class TrainState:
    step: int                    # iter_num
    epoch: int                   # epoch_num (hardness forcing)
    student: nn.Module
    teacher: nn.Module
    optimizer: torch.optim.SGD
    queue: CurriculumQueue
    lq: LQCarry
    choice_th: Any               # () f32 tensor, init 0.1 (train.py:561)
    generator: torch.Generator
    host_generator: torch.Generator
    graph: Any = None            # the captured step (step.StepGraph), CUDA


def _pl_shapes(q, s, multilabel, device):
    if multilabel:
        pl = torch.zeros((q, s, s, 2), device=device)
        conf = torch.zeros((q, s, s, 2), device=device)
    else:
        pl = torch.zeros((q, s, s), dtype=torch.int64, device=device)
        conf = torch.zeros((q, s, s, 1), device=device)
    return pl, conf


def make_optimizer(params, base_lr, fused=False):
    """torch SGD(momentum=0.9, wd=1e-4) over all parameters (train.py:512).
    The step sets each update's learning rate as a 0-d tensor on the
    parameters' device (`lr_at`'s value): on CUDA the fused update reads
    it from device memory (`fused`), so no update waits on the host and a
    captured update takes each replay's rate; on the CPU it is read as a
    number."""
    return torch.optim.SGD(params, lr=base_lr, momentum=0.9,
                           weight_decay=1e-4, fused=fused or None)


def lr_at(step, base_lr, max_iterations):
    """Poly schedule applied AFTER each reference step (train.py:854-856),
    so update k uses base*(1 - max(k-1, 0)/max)^0.9 (state.py:69-81);
    float32 like the JAX schedule."""
    eff = np.float32(max(step - 1, 0))
    return float(np.float32(base_lr) * (np.float32(1.0) - eff
                                        / np.float32(max_iterations))
                 ** np.float32(0.9))


def build_model(cfg, hp, generator, amp=False):
    """The model zoo (ust_run_tpu/engine/trainer.py:45-69) and the port's
    TransUNet (R50-ViT-B/16 at `transunet.R50_VIT_B16`, for the step's
    patch), weights drawn from `generator` on the CPU. `amp` (bf16
    autocast) reaches the UNet and TransUNet: the JAX package gives the
    other families no compute dtype, so they run in float32."""
    if cfg.model == "unet":
        return UNet(hp.channels, hp.num_classes, amp=amp) \
            .init_weights_(generator)
    if cfg.model == "transunet":
        return transunet.TransUNet(hp.channels, hp.num_classes, hp.patch,
                                   amp=amp, **transunet.R50_VIT_B16) \
            .init_weights_(generator)
    if cfg.model == "unet2d":
        return Unet2D(c=hp.channels, num_classes=hp.num_classes) \
            .init_weights_(generator)
    if cfg.model == "unet2d_dsbn":
        return Unet2D(c=hp.channels, num_classes=hp.num_classes, norm="dsbn",
                      num_domains=cfg.domain_num).init_weights_(generator)
    if cfg.model in ("deeplabv2", "deeplabv2_r50"):
        return DeepLabV2(backbone_arch(cfg.model), hp.num_classes,
                         hp.channels).init_weights_(generator)
    raise ValueError(f"unknown model {cfg.model!r}")


def backbone_arch(model):
    """The ResNet of a DeepLab --model value (trainer.py:190)."""
    return "resnet50" if model.endswith("r50") else "resnet101"


def create_train_state(hp, seed, device, student, teacher):
    """The train state around two models built with independent draws (the
    reference builds two fresh models, train.py:496-506; the first EMA
    update, alpha=0, snaps the teacher to the student); both move to
    `device`, channels_last."""
    student = student.to(device, memory_format=torch.channels_last)
    teacher = teacher.to(device, memory_format=torch.channels_last)
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
        optimizer=make_optimizer(student.parameters(), hp.base_lr,
                                 fused=torch.device(device).type == "cuda"),
        queue=queue, lq=lq,
        choice_th=torch.tensor(0.1, dtype=torch.float32, device=device),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
        host_generator=torch.Generator().manual_seed(seed + 2))


def reset_epoch(state, epoch):
    """Epoch boundary: the LQ carry is re-Noned (train.py:576), in place,
    and the epoch feeds the hardness forcing (train.py:711-713)."""
    state.epoch = epoch
    state.lq.valid.zero_()
    return state
