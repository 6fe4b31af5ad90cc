"""The port's train step as it was before it took a per-step feed: the
host numbers (FDA degree, consistency weight, learning rate, EMA's alpha,
the epoch-0 hardness flag) passed as Python scalars, the RNG kernel's
seed, the CutMix boxes and the LQ fallback drawn from the host generator
where they are used, and the state's queue, LQ carry and threshold
rebound to new tensors. A frozen copy, built on the port's unchanged
pieces, that `tests/test_torch_unroll_step.py` holds the feed-and-body
step to, bit for bit."""

import numpy as np
import torch

from ust_run_tpu_torch.ops import augment, cutmix, fda, rng
from ust_run_tpu_torch.semisup.state import LQCarry, lr_at
from ust_run_tpu_torch.semisup.step import (_mix_labels, _part_dice_parts,
                                            _pseudo_from_logits, _take,
                                            decode_mask, loss_terms,
                                            pack_metrics, teacher_forward,
                                            update_queue)
from ust_run_tpu_torch.utils import ramps


def _scalar(value, device):
    return torch.full((), float(value), dtype=torch.float32, device=device)


@torch.no_grad()
def build_inputs(state, data, idx, hp, mesh=None):
    """Everything the loss consumes (step.py:253-398). `data`: the corpus
    on the device (uint8 lb_img (N1,S,S,C), lb_lab (N1,S,S,K), lb_dc,
    ulb_* likewise); `idx`: {'lb_idx', 'ulb_idx'} int64 on the device."""
    b_lb, b_ulb, s = hp.label_bs, hp.unlabel_bs, hp.patch
    gen, host_gen = state.generator, state.host_generator
    dev = data["lb_img"].device

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
        size=s, fillcolor=hp.fillcolor, generator=gen,
        key=rng.draw_seed(host_gen))
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
    degree = np.float32(state.step) / np.float32(hp.max_iterations)
    move255 = fda.fda_batch(augment.denormalize(mix_img), ulb_img255,
                            float(degree), hp.LB, generator=gen)
    move_transx = augment.normalize(move255)

    # ------ cutmix boxes (train.py:639-642) -------------------------------
    label_box = cutmix.cutmix_boxes(b_ulb, s, hp.cutmix_prob,
                                    host_generator=host_gen, device=dev)
    img_box = label_box[..., None]

    # ------ teacher, one 3-group call (train.py:643-647) ------------------
    ulb_x_w_ul = ulb_x_w * (1 - img_box) + mix_img * img_box
    ulb_x_w_lu = mix_img * (1 - img_box) + ulb_x_w * img_box
    tea_logits = teacher_forward(
        state.teacher, torch.cat([ulb_x_w, ulb_x_w_ul, ulb_x_w_lu]), mesh)
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
    fallback = cutmix.to_device(
        cutmix.cutmix_box_params(cutmix.HostDraws(host_gen), s, p=1.0), dev)
    label_box_lq = cutmix.all_cover_box(region, fallback)[None]
    img_box_lq = label_box_lq[..., None]
    lq_s = lq.img * (1 - img_box_lq) \
        + _take(lb_x_w, new_choice) * img_box_lq
    pseudo_label_lq = _mix_labels(lq.pl, _take(lb_mask, new_choice),
                                  label_box_lq, hp)
    mask_lq = torch.where(img_box_lq > 0, torch.ones_like(lq.conf), lq.conf)

    # ------ consistency weight (train.py:819-820) -------------------------
    cons_w = ramps.consistency_weight(hp.consistency, state.step,
                                      hp.max_iterations,
                                      hp.consistency_rampup)

    return dict(
        lb_x_w=lb_x_w, ulb_x_w=ulb_x_w, ulb_x_s=ulb_x_s,
        ulb_x_s_ul=ulb_x_s_ul, ulb_x_s_lu=ulb_x_s_lu, lq_s=lq_s,
        lb_mask=lb_mask, ulb_mask=ulb_mask, ulb_dc=ulb_dc,
        pseudo_label=pseudo_label, mask=mask,
        pseudo_label_ul=pseudo_label_ul, mask_ul=mask_ul,
        pseudo_label_lu=pseudo_label_lu, mask_lu=mask_lu,
        pseudo_label_w=pseudo_label_w, mask_w=mask_w,
        pseudo_label_lq=pseudo_label_lq, mask_lq=mask_lq,
        lq_valid=lq.valid, cons_w=float(cons_w),
        ratio_before=ratio_before, ratio_after=ratio_after)


@torch.no_grad()
def ema_update(teacher, student, step, ema_decay):
    alpha = min(np.float32(1.0) - np.float32(1.0) / (np.float32(step) + 1),
                np.float32(ema_decay))
    ema = list(teacher.parameters())
    torch._foreach_mul_(ema, float(alpha))
    torch._foreach_add_(ema, list(student.parameters()),
                        alpha=float(np.float32(1.0) - alpha))


@torch.no_grad()
def apply_update(state, inp, loss, aux, hp, mesh=None):
    """After backward: SGD, EMA, hardness, queue, LQ carry, metrics
    (step.py:464-530). Returns the packed metric vector on the device.
    With `mesh`, the ranks' gradient shares are summed first."""
    dev = loss.device
    if mesh is not None:
        mesh.all_reduce_grads(state.student.parameters())
    lr = lr_at(state.step, hp.base_lr, hp.max_iterations)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    ema_update(state.teacher, state.student, state.step, hp.ema_decay)

    pseudo_label, mask = inp["pseudo_label"], inp["mask"]
    ulb_x_w, ulb_mask = inp["ulb_x_w"], inp["ulb_mask"]
    stu_pl, _ = _pseudo_from_logits(aux["stu_logits_w"], hp)
    hardness = 1.0 - torch.mean(_part_dice_parts(stu_pl, pseudo_label, hp),
                                dim=0)
    if state.epoch == 0:                                         # :711-713
        hardness = torch.ones_like(hardness)
    lq_idx = torch.argmax(hardness)                              # :714-718

    new_queue, new_th, qmetrics = update_queue(
        state.queue, state.choice_th, hardness, ulb_x_w, pseudo_label,
        ulb_mask, mask, inp["ulb_dc"], hp)

    simple_idx = hardness < state.choice_th
    ulb_dice = _part_dice_parts(pseudo_label, ulb_mask, hp)
    lq_dice = _part_dice_parts(_take(pseudo_label, lq_idx),
                               _take(ulb_mask, lq_idx), hp)
    cons_w = inp["cons_w"]
    metrics = dict(
        loss=loss.detach(), sup_loss=aux["sup_loss"].detach(),
        unsup_loss_ul=aux["unsup_ul"].detach(),
        unsup_loss_lu=aux["unsup_lu"].detach(),
        unsup_loss_s=aux["unsup_s"].detach(),
        consistency_weight=_scalar(cons_w, dev), mask_ratio=torch.mean(mask),
        ratio_before_ensemble=inp["ratio_before"],
        ratio_after_ensemble=inp["ratio_after"],
        ulb_dice=torch.mean(ulb_dice, dim=1),
        lq_dice=torch.mean(lq_dice, dim=1),
        hardness_mean=torch.mean(hardness),
        cur_simple_num=torch.sum(simple_idx.to(torch.float32)),
        simple_flags=simple_idx.to(torch.float32),
        queue_count=new_queue.count, choice_th=new_th,
        lr=_scalar(lr, dev), **qmetrics)

    state.lq = LQCarry(img=_take(ulb_x_w, lq_idx),
                       pl=_take(pseudo_label, lq_idx),
                       conf=_take(mask, lq_idx),
                       valid=torch.ones((), dtype=torch.bool, device=dev))
    state.queue = new_queue
    state.choice_th = new_th
    state.step += 1
    return pack_metrics(metrics, hp)


def step_fn(state, data, idx, hp, mesh=None):
    """One training step; returns the packed metrics (on the device)."""
    inp = build_inputs(state, data, idx, hp, mesh)
    state.optimizer.zero_grad(set_to_none=True)
    loss, aux = loss_terms(state, inp, hp, mesh)
    loss.backward()
    return apply_update(state, inp, loss, aux, hp, mesh)
