"""The plain UST-RUN SSL step in float32, one step at a time.

Follows upstream train.py:596-856 as the frozen copy of
ust_run_tpu_torch/semisup/step.py (`build_inputs`, `loss_terms`,
`apply_update`, `update_queue`, `draw_feed`) and semisup/state.py lays it
out, at the commit named in `benchmarks/reference/__init__.py`, with
every model call made per group (the teacher's three, the student's six)
and the optimizer written out (SGD, momentum 0.9, weight decay 1e-4, the
poly rate; then the EMA). It draws what the program draws from the
generators the program's state seeds (`seed + 1` on the device, `seed +
2` on the host) in the same order, so from the same weights, corpus and
index rows it computes the same step.

`fault` plants a fault for the harness's tests and limits:
"half_batch" computes every loss term over the first half of each
group's rows only; "half_batch_replay" does so from the second step on,
as a fault confined to the program's captured step would (its first step
is the capture's eager warm-up); "stale_rows" takes the first step's
index rows again at every later step, as a static input of the captured
step that is not refreshed would.
"""

import dataclasses

import numpy as np
import torch

from benchmarks.reference import losses as L
from benchmarks.reference import ops


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The step's settings, read from a configuration and a cell."""
    dataset: str
    patch: int
    channels: int
    num_classes: int
    multilabel: bool
    n_part: int
    label_bs: int
    unlabel_bs: int
    queue_len: int
    threshold: float
    cutmix_prob: float
    LB: float
    increase: float
    consistency: float
    consistency_rampup: float
    max_iterations: int
    ema_decay: float
    base_lr: float
    momentum: float
    weight_decay: float
    min_v: float
    max_v: float
    fillcolor: int

    @classmethod
    def of(cls, config, cell):
        t = config["training"]
        return cls(
            dataset=config["dataset"], patch=config["patch"],
            channels=config["channels"], num_classes=config["num_classes"],
            multilabel=config["multilabel"], n_part=config["n_part"],
            label_bs=cell["label_bs"], unlabel_bs=cell["unlabel_bs"],
            **{k: t[k] for k in (
                "queue_len", "threshold", "cutmix_prob", "LB", "increase",
                "consistency", "consistency_rampup", "max_iterations",
                "ema_decay", "base_lr", "momentum", "weight_decay", "min_v",
                "max_v", "fillcolor")})


def decode_mask(labels, dataset):
    if dataset == "fundus":
        lab = labels[..., 0]
        return torch.stack([lab == 0, lab <= 128], dim=-1).to(torch.float32)
    if dataset == "prostate":
        return (labels[..., 0] == 0).to(torch.int64)
    if dataset == "BUSI":
        return (labels[..., 0] == 255).to(torch.int64)
    m = torch.where(labels[..., 0] == 255, 1, 0)
    m = torch.where(labels[..., 1] == 255, 2, m)
    m = torch.where(labels[..., 2] == 255, 3, m)
    return m.to(torch.int64)


def pseudo_from_logits(logits, hp):
    if hp.multilabel:
        prob = torch.sigmoid(logits)
        pl = (prob >= 0.5).to(torch.float32)
        mask = (prob >= hp.threshold).to(torch.float32) \
            + (prob <= 1 - hp.threshold).to(torch.float32)
        return pl, mask
    prob = torch.softmax(logits, dim=-1)
    conf = torch.amax(prob, dim=-1)
    return torch.argmax(prob, dim=-1), \
        (conf > hp.threshold).to(torch.float32)[..., None]


def mix_labels(a, b, box, hp):
    if hp.multilabel:
        box = box[..., None]
        return a * (1 - box) + b * box
    return torch.where(box > 0, b, a)


def part_dice(pl, target, hp):
    if hp.multilabel or hp.n_part != 1:
        return L.dice_per_part(pl, target, hp.n_part)
    return L.dice_per_part(pl == 1, target == 1, 1)


class ReferenceStep:
    """Student, teacher, momentum, the curriculum queue and the LQ carry,
    stepped one step per `step(idx)` call."""

    def __init__(self, hp, student, teacher, seed, device, epoch=1,
                 fault=None):
        self.hp, self.fault, self.epoch = hp, fault, epoch
        self.student, self.teacher = student, teacher
        for p in teacher.parameters():
            p.requires_grad_(False)
        student.train()
        teacher.train()
        q, s, dev = hp.queue_len, hp.patch, device
        if hp.multilabel:
            def lab(n):
                return torch.zeros((n, s, s, 2), device=dev)
            conf_shape = (s, s, 2)
        else:
            def lab(n):
                return torch.zeros((n, s, s), dtype=torch.int64, device=dev)
            conf_shape = (s, s, 1)
        self.queue = dict(
            img=torch.zeros((q, s, s, hp.channels), device=dev),
            pl=lab(q), gt=lab(q), conf=torch.zeros((q,) + conf_shape,
                                                   device=dev),
            hardness=torch.zeros((q,), device=dev),
            dc=torch.zeros((q,), dtype=torch.int64, device=dev),
            valid=torch.zeros((q,), dtype=torch.bool, device=dev))
        self.lq = dict(img=torch.zeros((1, s, s, hp.channels), device=dev),
                       pl=lab(1), conf=torch.zeros((1,) + conf_shape,
                                                   device=dev),
                       valid=False)
        self.choice_th = torch.tensor(0.1, device=dev)
        self.momentum = {}
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)
        self.host_generator = torch.Generator().manual_seed(seed + 2)
        self.step_count = 0
        self.grads = None

    # -------------------------------------------------------------- feed
    def draw_host(self):
        """The step's host draws in the program's order: the Philox seed,
        one CutMix box per unlabelled sample, the LQ fallback box."""
        hp = self.hp
        seed = ops.draw_seed(self.host_generator)
        draws = ops.HostDraws(self.host_generator)
        boxes = [ops.cutmix_box_params(draws, hp.patch, hp.cutmix_prob)
                 for _ in range(hp.unlabel_bs)]
        fallback = ops.cutmix_box_params(draws, hp.patch, p=1.0)
        return seed, boxes, fallback

    # -------------------------------------------------------------- step
    def step(self, data, idx):
        """One step on the index rows `idx` {'lb_idx', 'ulb_idx'} (int64
        on the device); returns the loss (a float)."""
        hp, gen = self.hp, self.generator
        b_lb, b_ulb, s = hp.label_bs, hp.unlabel_bs, hp.patch
        dev = data["lb_img"].device
        it = self.step_count
        if it == 0:
            self.first_idx = idx
        elif self.fault == "stale_rows":
            idx = self.first_idx
        seed, boxes, fallback = self.draw_host()
        degree = np.float32(it) / np.float32(hp.max_iterations)
        cons_w = float(ops.consistency_weight(
            hp.consistency, it, hp.max_iterations, hp.consistency_rampup))

        with torch.no_grad():
            lb_img = data["lb_img"][idx["lb_idx"]]
            lb_lab = data["lb_lab"][idx["lb_idx"]]
            ulb_img = data["ulb_img"][idx["ulb_idx"]]
            ulb_lab = data["ulb_lab"][idx["ulb_idx"]]
            ulb_dc = data["ulb_dc"][idx["ulb_idx"]].to(torch.int64)

            img255, lab = ops.weak_augment(
                torch.cat([lb_img, ulb_img]), torch.cat([lb_lab, ulb_lab]),
                size=s, fillcolor=hp.fillcolor, generator=gen, seed=seed)
            lb_img255, ulb_img255 = img255[:b_lb], img255[b_lb:]
            ulb_s255 = ops.strong_augment(
                ulb_img255, min_v=hp.min_v, max_v=hp.max_v,
                blur_radius=ops.blur_radius_for(s), generator=gen)
            lb_x_w = ops.normalize(lb_img255)
            ulb_x_w = ops.normalize(ulb_img255)
            ulb_x_s = ops.normalize(ulb_s255)
            lb_mask = decode_mask(lab[:b_lb], hp.dataset)
            ulb_mask = decode_mask(lab[b_lb:], hp.dataset)

            # the cut pool: the labelled batch and the simple queue
            q = self.queue
            cnt = torch.sum(q["valid"].to(torch.int64))
            pool_img = torch.cat([lb_x_w, q["img"]])
            pool_pl = torch.cat([lb_mask, q["pl"]])
            pool_conf = torch.cat([torch.ones((b_lb,) + q["conf"].shape[1:],
                                              device=dev), q["conf"]])
            n_simple = torch.clamp(cnt, max=b_ulb // 2)
            lb_choice = torch.randint(0, b_lb, (b_ulb,), generator=gen,
                                      device=dev)
            q_choice = b_lb + torch.floor(
                torch.rand((b_ulb,), generator=gen, device=dev)
                * torch.clamp(cnt, min=1)).to(torch.int64)
            slot_is_q = torch.arange(b_ulb, device=dev) >= (b_ulb - n_simple)
            slot_is_q = slot_is_q[torch.randperm(b_ulb, generator=gen,
                                                 device=dev)]
            choice = torch.where(slot_is_q, q_choice, lb_choice)
            mix_img = pool_img[choice]
            cut_label = pool_pl[choice]
            cut_conf = pool_conf[choice]

            move = ops.normalize(ops.fda(ops.denormalize(mix_img),
                                         ulb_img255, float(degree), hp.LB,
                                         generator=gen))
            label_box = ops.box_masks(s, torch.tensor(boxes, device=dev))
            img_box = label_box[..., None]

            # the teacher, one forward a group
            ulb_x_w_ul = ulb_x_w * (1 - img_box) + mix_img * img_box
            ulb_x_w_lu = mix_img * (1 - img_box) + ulb_x_w * img_box
            logits_w, logits_w_ul, logits_w_lu = (
                self.teacher(x) for x in (ulb_x_w, ulb_x_w_ul, ulb_x_w_lu))
            pseudo_label, mask = pseudo_from_logits(logits_w, hp)
            pl_w_ul, mask_w_ul = pseudo_from_logits(logits_w_ul, hp)
            pl_w_lu, mask_w_lu = pseudo_from_logits(logits_w_lu, hp)

            # bidirectional ensemble
            mask_w = mask_w_ul * (1 - img_box) + mask_w_lu * img_box
            pseudo_label_w = mix_labels(pl_w_ul, pl_w_lu, label_box, hp)
            agree = (pseudo_label_w == pseudo_label).to(torch.float32)
            ens = agree * mask if hp.multilabel else agree[..., None] * mask
            mask_w = torch.where(ens == 0, torch.zeros_like(mask_w), mask_w)

            # the student's mixed inputs
            mask_ul = torch.where(img_box > 0, cut_conf, mask)
            mask_lu = torch.where(img_box > 0, mask, cut_conf)
            ulb_x_s_ul = ulb_x_s * (1 - img_box) + move * img_box
            ulb_x_s_lu = move * (1 - img_box) + ulb_x_s * img_box
            pl_ul = mix_labels(pseudo_label, cut_label, label_box, hp)
            pl_lu = mix_labels(cut_label, pseudo_label, label_box, hp)

            # the LQ composite of the previous step
            lq = self.lq
            new_choice = torch.randint(0, b_lb, (1,), generator=gen,
                                       device=dev)
            lb_pick = lb_mask[new_choice][0]
            if hp.multilabel:
                pl = lq["pl"][0]
                region = torch.maximum(pl[..., 1], pl[..., 0])
                region = torch.maximum(region, lb_pick[..., 0])
                region = torch.maximum(region, lb_pick[..., 1])
            else:
                region = torch.maximum((lq["pl"][0] > 0).to(torch.float32),
                                       (lb_pick > 0).to(torch.float32))
            box_lq = ops.all_cover_box(
                region, torch.tensor(fallback, device=dev))[None][..., None]
            lq_s = lq["img"] * (1 - box_lq) + lb_x_w[new_choice] * box_lq

        # the student, one forward a group, in the program's order
        for p in self.student.parameters():
            p.grad = None
        stu_w = self.student(ulb_x_w)
        logits_lb = self.student(lb_x_w)
        logits_ul = self.student(ulb_x_s_ul)
        logits_lu = self.student(ulb_x_s_lu)
        logits_s = self.student(ulb_x_s)
        if lq["valid"]:
            self.student(lq_s)
        kw = dict(multilabel=hp.multilabel, n_classes=hp.num_classes)
        half = self.fault == "half_batch" or (
            self.fault == "half_batch_replay" and it > 0)

        def term(logits, target, m=None):
            if half:
                n = logits.shape[0] // 2
                logits, target = logits[:n], target[:n]
                m = None if m is None else m[:n]
            return L.ce_plus_dice(logits, target, mask=m, **kw)

        sup = term(logits_lb, lb_mask)
        un_ul = term(logits_ul, pl_ul, mask_ul)
        un_lu = term(logits_lu, pl_lu, mask_lu)
        un_s = term(logits_s, pseudo_label_w, mask_w)
        loss = sup + cons_w * (un_ul + un_lu + cons_w * un_s)
        loss.backward()

        with torch.no_grad():
            self.grads = {n: p.grad.detach().clone()
                          for n, p in self.student.named_parameters()}
            self._sgd(ops.lr_at(it, hp.base_lr, hp.max_iterations))
            alpha = ops.ema_alpha(it, hp.ema_decay)
            beta = np.float32(1.0) - alpha
            for e, p in zip(self.teacher.parameters(),
                            self.student.parameters()):
                e.mul_(float(alpha)).add_(p * float(beta))

            stu_pl, _ = pseudo_from_logits(stu_w.detach(), hp)
            hardness = 1.0 - torch.mean(part_dice(stu_pl, pseudo_label, hp),
                                        dim=0)
            if self.epoch == 0:     # every sample is hard (train.py:711)
                hardness = torch.ones_like(hardness)
            lq_idx = torch.argmax(hardness)
            self._update_queue(hardness, ulb_x_w, pseudo_label, ulb_mask,
                               mask, ulb_dc)
            self.lq = dict(img=ulb_x_w[lq_idx][None],
                           pl=pseudo_label[lq_idx][None],
                           conf=mask[lq_idx][None], valid=True)
        self.step_count += 1
        return float(loss.detach())

    def _sgd(self, lr):
        hp = self.hp
        for name, p in self.student.named_parameters():
            d = p.grad + hp.weight_decay * p
            buf = self.momentum.get(name)
            buf = d.clone() if buf is None else buf * hp.momentum + d
            self.momentum[name] = buf
            p.sub_(float(lr) * buf)

    def _update_queue(self, hardness, ulb_x_w, pseudo_label, ulb_mask, mask,
                      ulb_dc):
        """Prepend the simple samples, keep the valid ones first in order,
        truncate to the queue's length; the threshold follows."""
        hp, q = self.hp, self.queue
        b, n = hp.unlabel_bs, hp.queue_len
        dev = hardness.device
        cnt = torch.sum(q["valid"].to(torch.int64))
        simple = hardness < self.choice_th
        cur_n = torch.sum(simple.to(torch.int64))
        total = b + n
        cand_valid = torch.cat([simple, q["valid"]])
        order = torch.arange(total, device=dev)
        key = order + total * (1 - cand_valid.to(torch.int64))
        perm = torch.argsort(key, stable=True)[:n]
        new = dict(img=ulb_x_w, pl=pseudo_label, gt=ulb_mask, conf=mask,
                   hardness=hardness, dc=ulb_dc)
        cand = {k: torch.cat([v, q[k]])[perm] for k, v in new.items()}
        cand["valid"] = torch.arange(n, device=dev) \
            < torch.clamp(cur_n + cnt, max=n)
        refresh = bool(cur_n > 0)
        buf_max = torch.max(torch.where(cand["valid"], cand["hardness"],
                                        -float("inf")))
        if refresh:
            self.queue = cand
            self.choice_th = torch.minimum(self.choice_th, buf_max)
        elif int(cnt) > 0:
            self.choice_th = torch.clamp(hp.increase * self.choice_th,
                                         max=0.1)
