"""Per-stage timing of the SSL step on the GPU (counterpart of the repo's
tools/perf_breakdown.py).

    python -m ust_run_tpu_torch.perf_breakdown [--dataset D] [--skip-full]
        [--n 20] [--device cpu] [--deterministic 0]

Times each stage of the step as the port runs it, on the JAX tool's
synthetic inputs (numpy RandomState(0), drawn in its order): the weak
augmentation of 8 images (it launches the uniform-field RNG kernel), the
strong augmentation and FDA of 4, the CutMix boxes, the teacher's 3-group
train-mode forward of 12 images, the student's 6-group forward of 21 with
four CE+Dice terms and its backward pass, the SGD step with the EMA; then
the whole step (`semisup/step.py:step_fn`) on a 64-image corpus. Each
stage: one warm-up call, then `n` calls on the host clock between two
synchronisations (the stream is serial: the last done means all done).
Numerics are the trainer's: TF32 off, the UNet under bf16 autocast on the
card, cuDNN deterministic unless `--deterministic 0`. Prints one JSON
object of ms per call, to 2 decimals, with the JAX tool's keys;
`stage_sum` sums every stage but `full_step`. `--skip-full` leaves the
whole step out.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ust_run_tpu_torch.bench import label_channels
from ust_run_tpu_torch.config import TrainConfig
from ust_run_tpu_torch.engine.trainer import set_numerics
from ust_run_tpu_torch.ops import augment, cutmix, fda
from ust_run_tpu_torch.ops.rng import draw_seed
from ust_run_tpu_torch.semisup.state import build_model, create_train_state
from ust_run_tpu_torch.semisup.step import (HyperParams, ema_alpha,
                                            ema_update, step_fn,
                                            teacher_forward)
from ust_run_tpu_torch.utils import losses as L
from ust_run_tpu_torch.utils.device import card_line, resolve_device

N_FULL_CORPUS = 64


def synthetic_inputs(hp, k, device, rng):
    """The JAX tool's stage inputs (tools/perf_breakdown.py:81-95), drawn
    from the numpy RandomState `rng` in its order, on `device`."""
    s, c, nc = hp.patch, hp.channels, hp.num_classes

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(device, dtype)

    img8 = t(rng.randint(0, 256, (8, s, s, c)))
    lab8 = t(rng.choice([0, 128, 255], (8, s, s, k)))
    x12 = t(rng.randn(12, s, s, c))
    x20 = t(rng.randn(20, s, s, c))
    if hp.multilabel:
        pl2 = t(rng.rand(4, s, s, nc) > 0.5)
        mask2 = torch.ones((4, s, s, nc), device=device)
    else:
        pl2 = t(rng.randint(0, nc, (4, s, s)), torch.int64)
        mask2 = torch.ones((4, s, s, 1), device=device)
    return dict(img8=img8, lab8=lab8, img4=img8[:4], x12=x12, x20=x20,
                x1=x12[:1], pl2=pl2, mask2=mask2)


def student_loss(student, x, target, mask, hp):
    """The student's one 6-group call [ulb_w, lb, ul, lu, s, lq] with
    every group valid and four CE+Dice terms on `target` plus 0 x the LQ
    group (tools/perf_breakdown.py:124-137); groups of hp's batch."""
    b_lb, b_ulb = hp.label_bs, hp.unlabel_bs
    sizes = (b_ulb, b_lb, b_ulb, b_ulb, b_ulb, 1)
    valid = torch.ones(6, dtype=torch.bool, device=x.device)
    parts = torch.split(student(x, group_sizes=sizes, group_valid=valid),
                        sizes)
    total = 0.0
    for lg in parts[1:5]:
        total = total + L.ce_plus_dice(lg, target, multilabel=hp.multilabel,
                                       n_classes=hp.num_classes, mask=mask)
    return total + 0.0 * torch.sum(parts[5])


def timeit(fn, n, device):
    """ms per call of `n` calls after one warm-up call, host clock between
    two synchronisations."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n * 1e3


def breakdown(cfg, device="cuda", n=20, skip_full=False):
    """{stage: ms per call} (rounded to 2 decimals) of the step of `cfg`
    on `device`, the JAX tool's keys in its order."""
    dev = resolve_device(device)
    set_numerics(cfg.deterministic, cfg.seed)
    hp = HyperParams.from_config(cfg)
    amp = bool(cfg.amp) and dev.type == "cuda"

    def new_state():
        init = torch.Generator().manual_seed(0)
        models = [build_model(cfg, hp, init, amp) for _ in range(2)]
        return create_train_state(hp, 0, dev, *models)

    state = new_state()
    gen, host_gen = state.generator, state.host_generator
    rng = np.random.RandomState(0)
    k = label_channels(cfg.dataset)
    x = synthetic_inputs(hp, k, dev, rng)
    s = hp.patch
    stu_in = torch.cat([x["x20"], x["x1"]])

    def student_grad():
        state.optimizer.zero_grad(set_to_none=True)
        student_loss(state.student, stu_in, x["pl2"], x["mask2"],
                     hp).backward()

    alpha = ema_alpha(state.step, hp.ema_decay)
    alpha_beta = torch.tensor([alpha, np.float32(1.0) - alpha], device=dev)

    def optimizer_ema():
        state.optimizer.step()
        ema_update(state.teacher, state.student, *alpha_beta)

    stages = {
        "weak_aug_8img": lambda: augment.weak_augment_batch(
            x["img8"], x["lab8"], size=s, fillcolor=hp.fillcolor,
            generator=gen, key=draw_seed(host_gen)),
        "strong_aug_4img": lambda: augment.strong_augment_batch(
            x["img4"], min_v=hp.min_v, max_v=hp.max_v,
            blur_radius=hp.blur_radius, generator=gen),
        "fda_4img": lambda: fda.fda_batch(x["img4"], x["img4"], 0.5, hp.LB,
                                          generator=gen),
        "cutmix_boxes": lambda: cutmix.cutmix_boxes(
            4, s, 1.0, host_generator=host_gen, device=dev),
        "teacher_fwd_12img": lambda: teacher_forward(state.teacher,
                                                     x["x12"]),
        "student_grad_21img": student_grad,
        # the gradients of the student stage's last call
        "optimizer_ema": optimizer_ema,
    }
    res = {name: timeit(fn, n, dev) for name, fn in stages.items()}

    if not skip_full:
        def t(a):
            return torch.from_numpy(np.asarray(a, np.uint8)).to(dev)
        m, c = N_FULL_CORPUS, hp.channels
        data = {"lb_img": t(rng.randint(0, 256, (m, s, s, c))),
                "lb_lab": t(rng.choice([0, 128, 255], (m, s, s, k))),
                "ulb_img": t(rng.randint(0, 256, (m, s, s, c))),
                "ulb_lab": t(rng.choice([0, 128, 255], (m, s, s, k))),
                "ulb_dc": torch.ones((m,), dtype=torch.int32, device=dev)}
        idx = {"lb_idx": torch.arange(hp.label_bs, device=dev),
               "ulb_idx": torch.arange(hp.unlabel_bs, device=dev)}
        # the step from the initial state, as the JAX tool's
        full = new_state()
        res["full_step"] = timeit(lambda: step_fn(full, data, idx, hp), n,
                                  dev)
    res["stage_sum"] = sum(v for name, v in res.items()
                           if name != "full_step")
    return {name: round(v, 2) for name, v in res.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="fundus")
    ap.add_argument("--skip-full", action="store_true",
                    help="skip the whole step's timing")
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--deterministic", type=int, default=1,
                    help="the train entry's flag: 1 (default) deterministic "
                    "cuDNN, 0 cuDNN's benchmarked choice")
    args = ap.parse_args(argv)
    cfg = TrainConfig(dataset=args.dataset).resolve()
    cfg.deterministic = args.deterministic
    res = breakdown(cfg, args.device, args.n, args.skip_full)
    print(f"[perf_breakdown] {card_line(resolve_device(args.device))} | "
          f"{cfg.dataset} {cfg.model}, patch {cfg.profile().patch_size}, "
          f"{args.n} calls per stage", file=sys.stderr, flush=True)
    print(json.dumps(res, indent=1), flush=True)


if __name__ == "__main__":
    main()
