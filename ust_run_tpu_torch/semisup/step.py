"""The UST-RUN training step (port of ust_run_tpu/semisup/step.py).

One step, in the JAX package's three parts (step.py:210-237) so tests can
drive each:
  * `build_inputs(state, data, idx, hp)`: on-device batch assembly from
    the device-resident corpus, weak/strong augmentation, FDA, CutMix, the
    teacher's one 3-group forward (train mode, updating the EMA model's
    BN statistics, train.py:643-647), pseudo-labels, the bidirectional
    ensemble, the LQ composite and the consistency weight;
  * `loss_terms(state, inp, hp)`: the student's one 21-image, 6-group
    forward [ulb_w, lb, ul, lu, s, lq] and the CE+Dice terms;
  * `apply_update(state, inp, loss, aux, hp)`: SGD, EMA, hardness, the
    curriculum queue and LQ carry, and the packed metrics.
`step_fn` chains them with the backward pass; `multi_step` runs K steps
in one call (the JAX package's make_train_multi_step, step.py:644-659).

Each part takes an optional `mesh` (parallel.Mesh): N ranks then
compute what one process computes with the same global batch. Everything
in `build_inputs` and `apply_update` is replicated (every rank draws the
same numbers); the two model calls are sharded, each rank taking a
contiguous slice of each group over the data axis (the LQ group of 1
lives on one data index) and, with a space axis, a slab of every image's
rows, and their logits are gathered where the replicated part needs them;
the loss terms of each rank's share reduce their partial sums over the
ranks and the gradients are summed before SGD (parallel/mesh.py).
Without a mesh, nothing changes.

Nothing in the step waits on the device: shapes are fixed, choices are
`torch.where`, and what the host supplies comes in one "feed" per step, a
(F,) int32 tensor drawn by `draw_feed` (`feed_width`, `unpack_feed`): the
RNG kernel's key, the CutMix boxes and the LQ fallback box, drawn from the
CPU `host_generator` in that order, and the numbers of the host step
count in float32 (the FDA degree, the consistency weight, the learning
rate, EMA's alpha and 1 - alpha) with the epoch-0 hardness flag. The
body (`build_inputs`, `loss_terms`, backward, `apply_update`) reads only
device tensors and writes the state in place, so one captured CUDA graph
of it serves every step: `multi_step` captures the step once per state,
hyperparameters and corpus, and replays it K times per call, copying
row k of the call's (K, ...) index and feed tensors into the graph's
inputs before replay k and its metrics out after it. On an NCCL mesh the
graph holds the step's collectives too (NCCL's kernels are captured like
any other); on the CPU, and on a Gloo mesh, whose collectives run on the
host and cannot be captured, `multi_step` runs K eager bodies. Gradients flow only
through `loss_terms`; pseudo-labels, the hardness and all state updates
are computed without autograd.
"""

import dataclasses
import logging

import numpy as np
import torch
import torch.distributed as dist

from ust_run_tpu_torch.ops import (attention, augment, cutmix, fda,
                                   grouped_bn, rng)
from ust_run_tpu_torch.semisup.state import CurriculumQueue, lr_at
from ust_run_tpu_torch.utils import losses as L
from ust_run_tpu_torch.utils import metrics as M
from ust_run_tpu_torch.utils import ramps, trace
from ust_run_tpu_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Static configuration of the train step (step.py:40-91)."""
    dataset: str
    patch: int
    channels: int
    num_classes: int
    multilabel: bool
    n_part: int
    label_bs: int
    unlabel_bs: int
    queue_len: int
    domain_num: int
    threshold: float
    cutmix_prob: float
    LB: float
    increase: float
    consistency: float
    consistency_rampup: float
    max_iterations: int
    ema_decay: float
    base_lr: float
    min_v: float
    max_v: float
    fillcolor: int
    blur_radius: int
    # Include the LQ sample in the unsup_ul loss. Dead code upstream
    # (train.py:743 vs :822-823); False reproduces the reference.
    lq_loss: bool = False

    @classmethod
    def from_config(cls, cfg):
        p = cfg.profile()
        return cls(
            dataset=cfg.dataset, patch=p.patch_size, channels=p.num_channels,
            num_classes=p.num_classes, multilabel=p.multilabel,
            n_part=p.n_part, label_bs=cfg.label_bs, unlabel_bs=cfg.unlabel_bs,
            queue_len=cfg.queue_len, domain_num=cfg.domain_num,
            threshold=cfg.threshold, cutmix_prob=cfg.cutmix_prob, LB=cfg.LB,
            increase=cfg.increase, consistency=cfg.consistency,
            consistency_rampup=cfg.consistency_rampup,
            max_iterations=cfg.max_iterations, ema_decay=cfg.ema_decay,
            base_lr=cfg.base_lr, min_v=p.min_v, max_v=p.max_v,
            fillcolor=p.fillcolor,
            blur_radius=augment.blur_radius_for(p.patch_size),
            lq_loss=cfg.lq_consistency)


_FEED_FLOATS = ("degree", "cons_w", "lr", "alpha", "beta")


def feed_width(hp):
    """F, the int32 words of one step's feed: key 2, CutMix boxes 4 per
    unlabelled sample, LQ fallback box 4, the float32 numbers (bit
    patterns) and the epoch-0 flag."""
    return 2 + 4 * hp.unlabel_bs + 4 + len(_FEED_FLOATS) + 1


def ema_alpha(step, ema_decay):
    """min(1 - 1/(step+1), decay) in float32 (train.py:87-93)."""
    return min(np.float32(1.0) - np.float32(1.0) / (np.float32(step) + 1),
               np.float32(ema_decay))


def step_numbers(step, hp):
    """The float32 numbers of host step `step`: FDA degree (train.py:629),
    consistency weight (train.py:819-820), learning rate (train.py:854-856)
    and EMA's alpha and 1 - alpha, as `_FEED_FLOATS` orders them."""
    alpha = ema_alpha(step, hp.ema_decay)
    return np.array([
        np.float32(step) / np.float32(hp.max_iterations),
        ramps.consistency_weight(hp.consistency, step, hp.max_iterations,
                                 hp.consistency_rampup),
        lr_at(step, hp.base_lr, hp.max_iterations),
        alpha, np.float32(1.0) - alpha], np.float32)


def pack_feed(hp, step, epoch, key=(0, 0), boxes=None, fallback=(0, 0, 0, 0)):
    """One step's feed as a (F,) int32 numpy array."""
    if boxes is None:
        boxes = np.zeros((hp.unlabel_bs, 4), np.int32)
    return np.concatenate([
        np.asarray(key, np.int32), np.asarray(boxes, np.int32).reshape(-1),
        np.asarray(fallback, np.int32),
        step_numbers(step, hp).view(np.int32),
        np.asarray([epoch == 0], np.int32)])


def draw_feed(state, hp, step=None):
    """The feed of the step at host count `step` (default the state's):
    the RNG kernel's key, the CutMix boxes and the LQ fallback box drawn
    from `state.host_generator` in that order (the order the step used
    them in before it took a feed, so the same generators give the same
    draws), and that step's numbers."""
    with span("call.feeds"):
        host = state.host_generator
        key = rng.draw_key(host)
        draws = cutmix.HostDraws(host)
        boxes = [cutmix.cutmix_box_params(draws, hp.patch, hp.cutmix_prob)
                 for _ in range(hp.unlabel_bs)]
        fallback = cutmix.cutmix_box_params(draws, hp.patch, p=1.0)
        return pack_feed(hp, state.step if step is None else step,
                         state.epoch, key, boxes, fallback)


def draw_feeds(state, hp, k):
    """(k, F) int32: the feeds of the state's next k steps, drawn in
    order (the epoch's, as no call crosses an epoch boundary)."""
    return np.stack([draw_feed(state, hp, state.step + i) for i in range(k)])


def unpack_feed(feed, hp):
    """(F,) int32 tensor -> views of it: key (2,) int32, boxes (B, 4) and
    fallback (4,) int32, the `_FEED_FLOATS` as 0-d float32 and
    `force_hard` 0-d bool."""
    b = hp.unlabel_bs
    out = dict(key=feed[0:2], boxes=feed[2:2 + 4 * b].view(b, 4),
               fallback=feed[2 + 4 * b:6 + 4 * b])
    nums = feed[6 + 4 * b:6 + 4 * b + len(_FEED_FLOATS)].view(torch.float32)
    out.update({name: nums[i] for i, name in enumerate(_FEED_FLOATS)})
    out["force_hard"] = feed[-1] != 0
    return out


def host_to_device(array, device):
    """A host numpy array -> tensor on `device`; to a CUDA device through
    pinned memory without blocking."""
    with span("call.to_device"):
        t = torch.from_numpy(np.ascontiguousarray(array))
        if torch.device(device).type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t


def decode_mask(labels, dataset):
    """Raw (B,S,S,K) label values -> training targets (step.py:94-117).

    fundus:   cup = label==0, disc = label<=128 -> (B,S,S,2) f32
    prostate: label==0 -> (B,S,S) i64
    BUSI:     label==255 -> (B,S,S) i64
    MNMS:     3-channel one-hot-by-255 -> classes 1..3, later channels win
    """
    if dataset == "fundus":
        lab = labels[..., 0]
        return torch.stack([lab == 0, lab <= 128], dim=-1).to(torch.float32)
    if dataset == "prostate":
        return (labels[..., 0] == 0).to(torch.int64)
    if dataset == "BUSI":
        return (labels[..., 0] == 255).to(torch.int64)
    if dataset == "MNMS":
        m = torch.where(labels[..., 0] == 255, 1, 0)
        m = torch.where(labels[..., 1] == 255, 2, m)
        m = torch.where(labels[..., 2] == 255, 3, m)
        return m.to(torch.int64)
    raise ValueError(dataset)


def _pseudo_from_logits(logits, hp):
    """Teacher outputs -> (pseudo_label, conf_mask) (train.py:648-667)."""
    if hp.multilabel:
        prob = torch.sigmoid(logits)
        pl = (prob >= 0.5).to(torch.float32)
        mask = (prob >= hp.threshold).to(torch.float32) \
            + (prob <= 1 - hp.threshold).to(torch.float32)
        return pl, mask
    prob = torch.softmax(logits, dim=-1)
    conf = torch.amax(prob, dim=-1)
    mask = (conf > hp.threshold).to(torch.float32)[..., None]
    return torch.argmax(prob, dim=-1), mask


def _mix_labels(a, b, box, hp):
    """a*(1-box) + b*box (train.py:679,690,693); box (B,S,S) {0,1}."""
    if hp.multilabel:
        box = box[..., None]
        return a * (1 - box) + b * box
    return torch.where(box > 0, b, a)


def _part_dice_parts(pl, target, hp):
    """(n_part, B) per-sample dice between label maps."""
    if hp.multilabel or hp.n_part != 1:
        return M.dice_per_part(pl, target, hp.n_part)
    return M.dice_per_part(pl == 1, target == 1, 1)


def _take(x, idx):
    """x[idx] for a 0-d or 1-d device index, without a host sync."""
    return torch.index_select(x, 0, idx.reshape(-1))


def metric_spec(hp):
    """Layout of the packed per-step metric vector (step.py:165-180)."""
    p, d = hp.n_part, hp.domain_num
    return [
        ("loss", 1), ("sup_loss", 1), ("unsup_loss_ul", 1),
        ("unsup_loss_lu", 1), ("unsup_loss_s", 1),
        ("consistency_weight", 1), ("mask_ratio", 1),
        ("ratio_before_ensemble", 1), ("ratio_after_ensemble", 1),
        ("ulb_dice", p), ("lq_dice", p), ("hardness_mean", 1),
        ("cur_simple_num", 1), ("queue_count", 1), ("choice_th", 1),
        ("lr", 1), ("cur_simple_dice", p), ("other_ulb_dice", p),
        ("queue_dice", p), ("simple_dc_counts", d), ("simple_hardness", 1),
        ("simple_flags", hp.unlabel_bs),
    ]


_VECTOR_METRICS = frozenset([
    "ulb_dice", "lq_dice", "cur_simple_dice", "other_ulb_dice",
    "queue_dice", "simple_dc_counts", "simple_flags"])


def pack_metrics(metrics, hp):
    return torch.cat([metrics[name].to(torch.float32).reshape(n)
                      for name, n in metric_spec(hp)])


def unpack_metrics(vec, hp):
    """numpy vector -> dict; per-part/per-domain metrics stay 1-D, true
    scalars come back 0-d (step.py:195-207)."""
    out = {}
    i = 0
    for name, n in metric_spec(hp):
        out[name] = np.asarray(vec[i:i + n]) if name in _VECTOR_METRICS \
            else np.asarray(vec[i])
        i += n
    return out


def teacher_forward(teacher, tea_in, mesh=None):
    """The EMA model's 3-group train-mode forward (train.py:643-647): its
    BN running statistics fold the three groups, as the JAX step's
    `tea_batch_stats`. With `mesh`, each rank runs its slice of each group
    and the logits are gathered onto every rank."""
    with torch.no_grad():
        if mesh is None:
            return teacher(tea_in, groups=3)
        sizes = (tea_in.shape[0] // 3,) * 3
        x, local = mesh.shard(tea_in, sizes)
        return mesh.gather(teacher(x, group_sizes=local), sizes,
                           tea_in.shape[1])


def _shard(mesh, x, n):
    """This rank's share of a batch of n samples (all of it without a
    mesh)."""
    return x if mesh is None else mesh.shard(x, (n,))[0]


@torch.no_grad()
def build_inputs(state, data, idx, hp, mesh=None, *, feed):
    """Everything the loss consumes (step.py:253-398). `data`: the corpus
    on the device (uint8 lb_img (N1,S,S,C), lb_lab (N1,S,S,K), lb_dc,
    ulb_* likewise); `idx`: {'lb_idx', 'ulb_idx'} int64 on the device;
    `feed`: this step's (F,) int32 feed on the device (`draw_feed`). The
    unpacked feed rides along as `inp["feed"]`."""
    b_lb, b_ulb, s = hp.label_bs, hp.unlabel_bs, hp.patch
    gen = state.generator
    dev = data["lb_img"].device
    f = unpack_feed(feed, hp)

    # ------ on-device batch assembly from the resident corpus ------------
    lb_idx, ulb_idx = idx["lb_idx"], idx["ulb_idx"]
    lb_img = _take(data["lb_img"], lb_idx)
    lb_lab = _take(data["lb_lab"], lb_idx)
    ulb_img = _take(data["ulb_img"], ulb_idx)
    ulb_lab = _take(data["ulb_lab"], ulb_idx)
    ulb_dc = _take(data["ulb_dc"], ulb_idx).to(torch.int64)

    # ------ weak (one pass over [labeled; unlabeled]) and strong ---------
    all_img255, all_lab = augment.weak_augment_batch(
        torch.cat([lb_img, ulb_img]), torch.cat([lb_lab, ulb_lab]),
        size=s, fillcolor=hp.fillcolor, generator=gen, key=f["key"])
    lb_img255, ulb_img255 = all_img255[:b_lb], all_img255[b_lb:]
    lb_lab, ulb_lab = all_lab[:b_lb], all_lab[b_lb:]
    ulb_s255 = augment.strong_augment_batch(
        ulb_img255, min_v=hp.min_v, max_v=hp.max_v,
        blur_radius=hp.blur_radius, generator=gen)
    lb_x_w = augment.normalize(lb_img255)
    ulb_x_w = augment.normalize(ulb_img255)
    ulb_x_s = augment.normalize(ulb_s255)
    lb_mask = decode_mask(lb_lab, hp.dataset)
    ulb_mask = decode_mask(ulb_lab, hp.dataset)

    # ------ cut pool: labeled batch + simple queue (train.py:611-626) ----
    queue = state.queue
    cnt = queue.count
    ones_conf = torch.ones((b_lb,) + tuple(queue.conf.shape[1:]),
                           device=dev)
    pool_img = torch.cat([lb_x_w, queue.img])
    pool_pl = torch.cat([lb_mask, queue.pl])
    pool_conf = torch.cat([ones_conf, queue.conf])
    n_simple = torch.clamp(cnt, max=b_ulb // 2)                # :621
    lb_choice = torch.randint(0, b_lb, (b_ulb,), generator=gen, device=dev)
    q_choice = b_lb + torch.floor(
        torch.rand((b_ulb,), generator=gen, device=dev)
        * torch.clamp(cnt, min=1)).to(torch.int64)
    slot_is_q = torch.arange(b_ulb, device=dev) >= (b_ulb - n_simple)
    slot_is_q = slot_is_q[torch.randperm(b_ulb, generator=gen,
                                         device=dev)]          # :625
    choice = torch.where(slot_is_q, q_choice, lb_choice)
    mix_img = pool_img[choice]
    cut_label_choice = pool_pl[choice]
    cut_mask_choice = pool_conf[choice]

    # ------ FDA restyle toward the unlabeled batch (train.py:629-636) ----
    move255 = fda.fda_batch(augment.denormalize(mix_img), ulb_img255,
                            f["degree"], hp.LB, generator=gen)
    move_transx = augment.normalize(move255)

    # ------ cutmix boxes (train.py:639-642) -------------------------------
    label_box = cutmix.box_masks(s, f["boxes"])
    img_box = label_box[..., None]

    # ------ teacher, one 3-group call (train.py:643-647) ------------------
    ulb_x_w_ul = ulb_x_w * (1 - img_box) + mix_img * img_box
    ulb_x_w_lu = mix_img * (1 - img_box) + ulb_x_w * img_box
    with span("step.teacher_fwd", dev):
        tea_logits = teacher_forward(
            state.teacher, torch.cat([ulb_x_w, ulb_x_w_ul, ulb_x_w_lu]),
            mesh)
    logits_w, logits_w_ul, logits_w_lu = torch.split(tea_logits, b_ulb)
    pseudo_label, mask = _pseudo_from_logits(logits_w, hp)
    pl_w_ul, mask_w_ul = _pseudo_from_logits(logits_w_ul, hp)
    pl_w_lu, mask_w_lu = _pseudo_from_logits(logits_w_lu, hp)

    # ------ bidirectional ensemble (train.py:677-686) ---------------------
    mask_w = mask_w_ul * (1 - img_box) + mask_w_lu * img_box
    ratio_before = torch.mean(mask_w)
    pseudo_label_w = _mix_labels(pl_w_ul, pl_w_lu, label_box, hp)
    agree = (pseudo_label_w == pseudo_label).to(torch.float32)
    ensemble = agree * mask if hp.multilabel else agree[..., None] * mask
    mask_w = torch.where(ensemble == 0, torch.zeros_like(mask_w), mask_w)
    ratio_after = torch.mean(mask_w)

    # ------ student mixed inputs (train.py:688-697) -----------------------
    mask_ul = torch.where(img_box > 0, cut_mask_choice, mask)
    mask_lu = torch.where(img_box > 0, mask, cut_mask_choice)
    ulb_x_s_ul = ulb_x_s * (1 - img_box) + move_transx * img_box
    ulb_x_s_lu = move_transx * (1 - img_box) + ulb_x_s * img_box
    pseudo_label_ul = _mix_labels(pseudo_label, cut_label_choice,
                                  label_box, hp)
    pseudo_label_lu = _mix_labels(cut_label_choice, pseudo_label,
                                  label_box, hp)

    # ------ LQ composite from the PREVIOUS step (train.py:720-743) --------
    lq = state.lq
    new_choice = torch.randint(0, b_lb, (1,), generator=gen, device=dev)
    lb_pick = _take(lb_mask, new_choice)[0]
    if hp.multilabel:
        region = torch.maximum(lq.pl[0, ..., 1], lq.pl[0, ..., 0])
        region = torch.maximum(region, lb_pick[..., 0])
        region = torch.maximum(region, lb_pick[..., 1])
    else:
        region = torch.maximum((lq.pl[0] > 0).to(torch.float32),
                               (lb_pick > 0).to(torch.float32))
    label_box_lq = cutmix.all_cover_box(region, f["fallback"])[None]
    img_box_lq = label_box_lq[..., None]
    lq_s = lq.img * (1 - img_box_lq) \
        + _take(lb_x_w, new_choice) * img_box_lq
    pseudo_label_lq = _mix_labels(lq.pl, _take(lb_mask, new_choice),
                                  label_box_lq, hp)
    mask_lq = torch.where(img_box_lq > 0, torch.ones_like(lq.conf), lq.conf)

    return dict(
        lb_x_w=lb_x_w, ulb_x_w=ulb_x_w, ulb_x_s=ulb_x_s,
        ulb_x_s_ul=ulb_x_s_ul, ulb_x_s_lu=ulb_x_s_lu, lq_s=lq_s,
        lb_mask=lb_mask, ulb_mask=ulb_mask, ulb_dc=ulb_dc,
        pseudo_label=pseudo_label, mask=mask,
        pseudo_label_ul=pseudo_label_ul, mask_ul=mask_ul,
        pseudo_label_lu=pseudo_label_lu, mask_lu=mask_lu,
        pseudo_label_w=pseudo_label_w, mask_w=mask_w,
        pseudo_label_lq=pseudo_label_lq, mask_lq=mask_lq,
        lq_valid=lq.valid, cons_w=f["cons_w"],
        ratio_before=ratio_before, ratio_after=ratio_after, feed=f)


def loss_terms(state, inp, hp, mesh=None):
    """The student's one 21-image, 6-group forward (train.py:668-674,
    699-702, 740) and the loss (train.py:816-838) -> (total, aux). The
    LQ group's running-stat fold is conditional on `lq_valid`. With
    `mesh`, the forward and the loss terms' sums cover this rank's share
    of each group; the terms are the global batch's and
    `stu_logits_w` is gathered."""
    b_lb, b_ulb = hp.label_bs, hp.unlabel_bs
    stu_in = torch.cat([inp["ulb_x_w"], inp["lb_x_w"], inp["ulb_x_s_ul"],
                        inp["ulb_x_s_lu"], inp["ulb_x_s"], inp["lq_s"]])
    sizes = (b_ulb, b_lb, b_ulb, b_ulb, b_ulb, 1)
    valid6 = torch.cat([torch.ones(5, dtype=torch.bool,
                                   device=stu_in.device),
                        inp["lq_valid"].reshape(1).to(torch.bool)])
    local = sizes
    if mesh is not None:
        stu_in, local = mesh.shard(stu_in, sizes)
    logits = state.student(stu_in, group_sizes=local, group_valid=valid6)
    (stu_logits_w, logits_lb, logits_ul, logits_lu, logits_s,
     logits_lq) = torch.split(logits, list(local))
    cons_w = inp["cons_w"]
    kw = dict(multilabel=hp.multilabel, n_classes=hp.num_classes, mesh=mesh,
              height=hp.patch)

    def mine(name, n=b_ulb):
        return _shard(mesh, inp[name], n)

    sup_loss = L.ce_plus_dice(logits_lb, mine("lb_mask", b_lb), rows=b_lb,
                              **kw)
    unsup_ul = L.ce_plus_dice(logits_ul, mine("pseudo_label_ul"),
                              mask=mine("mask_ul"), rows=b_ulb, **kw)
    if hp.lq_loss:
        # opt-in: the LQ sample joins unsup_ul when valid (train.py:822-830)
        ul_with = L.ce_plus_dice(
            torch.cat([logits_ul, logits_lq]),
            torch.cat([mine("pseudo_label_ul"), mine("pseudo_label_lq", 1)]),
            mask=torch.cat([mine("mask_ul"), mine("mask_lq", 1)]),
            rows=b_ulb + 1, **kw)
        unsup_ul = torch.where(inp["lq_valid"], ul_with, unsup_ul)
    unsup_lu = L.ce_plus_dice(logits_lu, mine("pseudo_label_lu"),
                              mask=mine("mask_lu"), rows=b_ulb, **kw)
    unsup_s = L.ce_plus_dice(logits_s, mine("pseudo_label_w"),
                             mask=mine("mask_w"), rows=b_ulb, **kw)
    total = sup_loss + cons_w * (unsup_ul + unsup_lu
                                 + cons_w * unsup_s)            # :838
    stu_logits_w = stu_logits_w.detach()
    if mesh is not None:
        stu_logits_w = mesh.gather(stu_logits_w, (b_ulb,), hp.patch)
    aux = dict(stu_logits_w=stu_logits_w, sup_loss=sup_loss,
               unsup_ul=unsup_ul, unsup_lu=unsup_lu, unsup_s=unsup_s)
    return total, aux


@torch.no_grad()
def ema_update(teacher, student, alpha, beta):
    """e = alpha*e + beta*p over the parameters (train.py:87-93, 851),
    alpha (`ema_alpha`) and beta = 1 - alpha 0-d float32 tensors on the
    parameters' device: e*alpha, then e + p*beta in one rounding (an
    addcmul, as the add with a host alpha it replaces). The teacher's BN
    statistics come from its own forward, not from the student."""
    ema = list(teacher.parameters())
    torch._foreach_mul_(ema, alpha)
    torch._foreach_addcmul_(ema, list(student.parameters()),
                            [beta] * len(ema))


@torch.no_grad()
def update_queue(queue, choice_th, hardness, ulb_x_w, pseudo_label,
                 ulb_mask, mask, ulb_dc, hp):
    """Fixed-shape queue transition (train.py:754-807; step.py:553-616):
    prepend the simple samples, keep valid entries first in a stable
    order, truncate to queue_len; refresh only when a sample was simple."""
    b_ulb, q = hp.unlabel_bs, hp.queue_len
    dev = hardness.device
    cnt = queue.count
    was_empty = cnt == 0
    simple_idx = hardness < choice_th                           # :754
    cur_n = torch.sum(simple_idx.to(torch.int64))

    total = b_ulb + q
    cand_valid = torch.cat([simple_idx, queue.valid])
    order = torch.arange(total, device=dev)
    sort_key = order + total * (1 - cand_valid.to(torch.int64))
    perm = torch.argsort(sort_key, stable=True)[:q]

    new = dict(img=ulb_x_w, pl=pseudo_label, gt=ulb_mask, conf=mask,
               hardness=hardness, dc=ulb_dc)
    old = queue.fields()
    cand = {k: torch.cat([v, old[k]])[perm] for k, v in new.items()}
    cand["valid"] = torch.arange(q, device=dev) \
        < torch.clamp(cur_n + cnt, max=q)
    do_refresh = cur_n > 0
    new_queue = CurriculumQueue(**{k: torch.where(do_refresh, cand[k], old[k])
                                   for k in old})

    # choice_th (train.py:763-779): refresh -> clamp to the max hardness in
    # the new buffer; stagnant non-empty -> x increase, capped at 0.1;
    # empty and nothing new -> unchanged.
    buf_max = torch.max(torch.where(cand["valid"], cand["hardness"],
                                    -float("inf")))
    th_refresh = torch.minimum(choice_th, buf_max)
    th_increase = torch.clamp(hp.increase * choice_th, max=0.1)
    new_th = torch.where(do_refresh, th_refresh,
                         torch.where(was_empty, choice_th, th_increase))

    # epoch diagnostics (train.py:783-814)
    sim_f = simple_idx.to(torch.float32)
    cur_dice = _part_dice_parts(pseudo_label, ulb_mask, hp)      # (P,B)
    n_sim = torch.clamp(torch.sum(sim_f), min=1)
    cur_simple_dice = torch.sum(cur_dice * sim_f, dim=1) / n_sim
    other_f = 1.0 - sim_f
    other_dice = torch.sum(cur_dice * other_f, dim=1) \
        / torch.clamp(torch.sum(other_f), min=1)
    qd = _part_dice_parts(new_queue.pl, new_queue.gt, hp)         # (P,Q)
    qv = new_queue.valid.to(torch.float32)
    queue_dice = torch.where(
        torch.sum(qv) > 0,
        torch.sum(qd * qv, dim=1) / torch.clamp(torch.sum(qv), min=1),
        -torch.ones((hp.n_part,), device=dev))
    dc_onehot = ((ulb_dc[:, None] - 1)
                 == torch.arange(hp.domain_num, device=dev)).to(torch.float32)
    qmetrics = dict(cur_simple_dice=cur_simple_dice,
                    other_ulb_dice=other_dice, queue_dice=queue_dice,
                    simple_dc_counts=torch.sum(dc_onehot * sim_f[:, None],
                                               dim=0),
                    simple_hardness=torch.sum(hardness * sim_f) / n_sim)
    return new_queue, new_th, qmetrics


@torch.no_grad()
def apply_update(state, inp, loss, aux, hp, mesh=None):
    """After backward: SGD, EMA, hardness, queue, LQ carry, metrics
    (step.py:464-530), written into the state's tensors in place; the
    host step count goes up by one. Returns the packed metric vector on
    the device. The step's numbers come from `inp["feed"]` (the unpacked
    feed). With `mesh`, the ranks' gradient shares are summed first."""
    f = inp["feed"]
    if mesh is not None:
        mesh.all_reduce_grads(state.student.parameters())
    for group in state.optimizer.param_groups:
        group["lr"] = f["lr"]
    state.optimizer.step()
    ema_update(state.teacher, state.student, f["alpha"], f["beta"])

    pseudo_label, mask = inp["pseudo_label"], inp["mask"]
    ulb_x_w, ulb_mask = inp["ulb_x_w"], inp["ulb_mask"]
    stu_pl, _ = _pseudo_from_logits(aux["stu_logits_w"], hp)
    hardness = 1.0 - torch.mean(_part_dice_parts(stu_pl, pseudo_label, hp),
                                dim=0)
    hardness = torch.where(f["force_hard"], torch.ones_like(hardness),
                           hardness)                             # :711-713
    lq_idx = torch.argmax(hardness)                              # :714-718

    new_queue, new_th, qmetrics = update_queue(
        state.queue, state.choice_th, hardness, ulb_x_w, pseudo_label,
        ulb_mask, mask, inp["ulb_dc"], hp)

    simple_idx = hardness < state.choice_th
    ulb_dice = _part_dice_parts(pseudo_label, ulb_mask, hp)
    lq_dice = _part_dice_parts(_take(pseudo_label, lq_idx),
                               _take(ulb_mask, lq_idx), hp)
    metrics = dict(
        loss=loss.detach(), sup_loss=aux["sup_loss"].detach(),
        unsup_loss_ul=aux["unsup_ul"].detach(),
        unsup_loss_lu=aux["unsup_lu"].detach(),
        unsup_loss_s=aux["unsup_s"].detach(),
        consistency_weight=f["cons_w"], mask_ratio=torch.mean(mask),
        ratio_before_ensemble=inp["ratio_before"],
        ratio_after_ensemble=inp["ratio_after"],
        ulb_dice=torch.mean(ulb_dice, dim=1),
        lq_dice=torch.mean(lq_dice, dim=1),
        hardness_mean=torch.mean(hardness),
        cur_simple_num=torch.sum(simple_idx.to(torch.float32)),
        simple_flags=simple_idx.to(torch.float32),
        queue_count=new_queue.count, choice_th=new_th, lr=f["lr"],
        **qmetrics)
    packed = pack_metrics(metrics, hp)

    lq = state.lq
    lq.img.copy_(_take(ulb_x_w, lq_idx))
    lq.pl.copy_(_take(pseudo_label, lq_idx))
    lq.conf.copy_(_take(mask, lq_idx))
    lq.valid.fill_(True)
    for name, t in state.queue.fields().items():
        t.copy_(getattr(new_queue, name))
    state.choice_th.copy_(new_th)
    state.step += 1
    return packed


def step_body(state, data, idx, feed, hp, mesh=None):
    """One step from its index batch and feed (after the gradients were
    set to None); returns the packed metrics (on the device). Each part
    is a clocked span (utils/trace.py)."""
    dev = feed.device
    with span("step.inputs", dev):
        inp = build_inputs(state, data, idx, hp, mesh, feed=feed)
    with span("step.student_fwd", dev):
        loss, aux = loss_terms(state, inp, hp, mesh)
    with span("step.backward", dev):
        loss.backward()
    with span("step.update", dev):
        return apply_update(state, inp, loss, aux, hp, mesh)


def _eager_step(state, data, idx, feed, hp, mesh=None):
    state.optimizer.zero_grad(set_to_none=True)
    return step_body(state, data, idx, feed, hp, mesh)


def step_fn(state, data, idx, hp, mesh=None):
    """One training step: its feed drawn and copied to the device, then
    the body; returns the packed metrics (on the device)."""
    feed = host_to_device(draw_feed(state, hp), data["lb_img"].device)
    return _eager_step(state, data, idx, feed, hp, mesh)


# Counts of the CUDA graph path (plain counts, reset by callers that want
# to show a run went through it): graphs captured, and replays.
graph_counts = dict(captures=0, replays=0)
# The ops that count their launches and captured calls
# (`launches`, `captured`).
COUNTED = (rng, grouped_bn, attention)


def reset_counts():
    """Zero the `launches` of rng, grouped_bn and attention,
    `graph_counts` and the stage clock."""
    for op in COUNTED:
        op.launches = 0
    graph_counts.update(dict.fromkeys(graph_counts, 0))
    trace.reset()


class StepGraph:
    """One captured step: the CUDA graph, its static index and feed inputs
    and metric output, what it was captured for (`key`), the addresses of
    the state's tensors it reads and writes, and the launches of each op
    of `COUNTED` that one replay runs (`per`, recorded at capture, added
    to each op's `launches` per replay)."""

    def __init__(self, key, graph, idx, feed, metrics, carried, per):
        self.key, self.graph = key, graph
        self.idx, self.feed, self.metrics = idx, feed, metrics
        self.carried, self.per = carried, per

    def replay(self, state, idx, feed):
        """One step: `idx` and `feed` into the static inputs, the replay;
        returns the static metrics (valid until the next replay)."""
        with span("call.replay"):
            self.feed.copy_(feed)
            for name, t in self.idx.items():
                t.copy_(idx[name])
            self.graph.replay()
        state.step += 1
        graph_counts["replays"] += 1
        for op, n in zip(COUNTED, self.per):
            op.launches += n
        return self.metrics


def _graph_key(data, hp, mesh=None):
    """What a captured step is valid for: the hyperparameters, the corpus
    tensors and, on a mesh, its layout (world, data x space, this rank's
    place), which with the batch sizes fixes every GroupSizes that
    `mesh.shard` hands the models and every halo plan."""
    layout = None if mesh is None else (
        mesh.world, mesh.data, mesh.space, mesh.data_index,
        mesh.space_index)
    return hp, layout, tuple((k, v.data_ptr(), tuple(v.shape), v.dtype)
                             for k, v in sorted(data.items()))


def _carried(state):
    """Addresses of every state tensor a step reads and writes."""
    ts = [*state.student.parameters(), *state.student.buffers(),
          *state.teacher.parameters(), *state.teacher.buffers(),
          *state.queue.fields().values(), *state.lq.fields().values(),
          state.choice_th]
    ts += [st["momentum_buffer"] for st in state.optimizer.state.values()
           if st.get("momentum_buffer") is not None]
    return tuple(t.data_ptr() for t in ts)


def _capture(state, data, idx, feed, hp, first_out, mesh=None):
    """The step captured as a CUDA graph. Runs the call's first step
    eagerly first (`idx`, `feed`: its rows; metrics into `first_out`), on
    the capture's side stream, as the warm-up that creates what the step
    makes on first use (momentum buffers, cached matrices and plans,
    library handles and workspaces, and on a mesh NCCL's communicators on
    that stream); then records the body, which runs nothing.
    The state's device generator is registered, so each replay advances
    it as the eager step would; the gradients are set to None first, so
    the backward's gradients are the graph's own, reused by each
    replay. A capture that fails raises: there is no eager fallback."""
    dev = feed.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        first_out.copy_(_eager_step(state, data, idx, feed, hp, mesh))
    torch.cuda.current_stream(dev).wait_stream(side)
    static_idx = {k: torch.empty_like(v) for k, v in idx.items()}
    static_feed = torch.empty_like(feed)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(state.generator)
    state.optimizer.zero_grad(set_to_none=True)
    step, captured = state.step, [op.captured for op in COUNTED]
    try:
        with torch.cuda.graph(graph, stream=side):
            metrics = step_body(state, data, static_idx, static_feed, hp,
                                mesh)
    finally:
        state.step = step                 # the capture ran no step
    graph_counts["captures"] += 1
    return StepGraph(_graph_key(data, hp, mesh), graph, static_idx,
                     static_feed, metrics, _carried(state),
                     tuple(op.captured - n
                           for op, n in zip(COUNTED, captured)))


_gloo_noted = False


def capturable(mesh):
    """Whether a step on `mesh` (None: no mesh) can be captured: NCCL's
    collectives are device kernels a CUDA graph records; Gloo's run on
    the host."""
    return mesh is None or dist.get_backend(mesh.group) == "nccl"


def multi_step(state, data, idxs, feeds, hp, mesh=None):
    """K steps in one call (make_train_multi_step): `idxs` {'lb_idx',
    'ulb_idx'} (K, B) int64 and `feeds` (K, F) int32 (`draw_feeds`), on
    the state's device; returns the (K, M) packed metrics on the device.
    On the CPU, or on a Gloo mesh, K eager bodies. On a CUDA device, with
    no mesh or an NCCL one, the step (its collectives too) is captured at
    the first call for this state, hyperparameters, corpus and mesh
    layout (that call's first step runs eagerly, see `_capture`) and
    replayed for every other step; a graph whose state tensors moved
    raises."""
    global _gloo_noted
    k = feeds.shape[0]

    def rows(i):
        return {name: v[i] for name, v in idxs.items()}

    if feeds.device.type != "cuda" or not capturable(mesh):
        if mesh is not None and feeds.device.type == "cuda" \
                and not _gloo_noted:
            _gloo_noted = True
            logging.info("K-step calls on a Gloo mesh run K eager steps "
                         "(Gloo's collectives run on the host: no CUDA "
                         "graph)")
        return torch.stack([_eager_step(state, data, rows(i), feeds[i], hp,
                                        mesh) for i in range(k)])
    out = torch.empty((k, sum(n for _, n in metric_spec(hp))),
                      device=feeds.device)
    g, start = state.graph, 0
    if g is None or g.key != _graph_key(data, hp, mesh):
        state.graph = None
        state.graph = g = _capture(state, data, rows(0), feeds[0], hp,
                                   out[0], mesh)
        start = 1
    if _carried(state) != g.carried:
        raise RuntimeError("a state tensor the captured step reads has "
                           "moved (rebound instead of written in place)")
    for i in range(start, k):
        out[i].copy_(g.replay(state, rows(i), feeds[i]))
    return out
