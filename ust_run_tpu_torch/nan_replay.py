"""Replay a UST_NAN_DEBUG dump to localise a non-finite training loss
(counterpart of tools/nan_replay.py).

    python -m ust_run_tpu_torch.nan_replay --dump DIR [--device cpu] \
        [--health-every N] -- <the train entry's flags>

The trainer's forensics mode (engine/trainer.py, UST_NAN_DEBUG=DIR) dumps
its last host snapshot of the train state (`state.pt`) and every index
batch applied after it (`batches.pt`: one entry per call, its K rows
stacked, and the run's `unroll`). This tool builds the trainer from
the same flags (config, datasets, corpus on the device), restores the
snapshot (models, SGD, queue, LQ, choice_th, both generators, the
samplers) and re-runs the batches one eager step at a time, with a
health line every `--health-every` steps and at the first non-finite loss
term, which it names by iteration and by its place in its K-step call.
The eager step computes what a call's steps compute, so the replay of a
one-process run fails at the iteration the trainer logged; one that
does not is a fault. The
replay runs in one process: a dump of a run over several ranks (its
`world` in `state.pt`) replays within float summation order of that run,
so a failure at the edge may not reproduce. At that step it goes back
to the state before it (the snapshot, then the steps that passed, again),
writes it to `prefail.pt` and takes the step apart as
tools/nan_replay.py:dissect does (the augmented inputs' ranges, teacher
and student logits, non-finite parameters and buffers, queue and LQ
health) with forward hooks that name the first module whose output is
non-finite, and runs the backward under `torch.autograd.detect_anomaly`.

Exit code 1 when the failure reproduces, 0 when it does not.
"""

import argparse
import os
import sys

import numpy as np
import torch

from ust_run_tpu_torch.config import build_parser, config_from_args
from ust_run_tpu_torch.engine import checkpoint as ckpt
from ust_run_tpu_torch.engine.trainer import (LOSS_TERMS, Trainer,
                                              weight_health)
from ust_run_tpu_torch.semisup.state import reset_epoch
from ust_run_tpu_torch.semisup.step import (build_inputs, draw_feed,
                                            host_to_device, loss_terms,
                                            step_fn, unpack_metrics)
from ust_run_tpu_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", required=True,
                    help="the UST_NAN_DEBUG directory")
    ap.add_argument("--health-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="overrides the train flags' --device")
    ap.add_argument("train_args", nargs="*")
    args = ap.parse_args(argv)
    cfg = config_from_args(build_parser().parse_args(args.train_args))
    if args.device is not None:
        cfg.device = args.device
    resolve_device(cfg.device)              # raise before reading the dump
    failed_at, _ = replay(cfg.resolve(), args.dump, args.health_every)
    return 0 if failed_at is None else 1


def replay(cfg, dump, health_every=10):
    """Re-run the dump's batches; returns (the first iteration with a
    non-finite loss term or None, the unpacked metrics of every step
    replayed)."""
    snap = torch.load(os.path.join(dump, "state.pt"), map_location="cpu",
                      weights_only=True)
    dumped = torch.load(os.path.join(dump, "batches.pt"), weights_only=True)
    unroll = dumped.get("unroll", 1)
    # one entry per step: (call, place in the call, batch)
    batches = [(c, j, {"epoch": b["epoch"], "lb_idx": lb, "ulb_idx": ulb})
               for c, b in enumerate(dumped["batches"])
               for j, (lb, ulb) in enumerate(zip(
                   b["lb_idx"].reshape(-1, b["lb_idx"].shape[-1]),
                   b["ulb_idx"].reshape(-1, b["ulb_idx"].shape[-1])))]
    trainer = Trainer(cfg, dump)
    try:
        state = trainer.state
        restore(trainer, snap["state"])
        it0 = snap["iter"]
        print(f"snapshot at iter {it0}, {len(batches)} single steps to "
              f"replay ({len(dumped['batches'])} calls of unroll {unroll})",
              flush=True)
        rows = []
        for i, (call, place, batch) in enumerate(batches):
            it = it0 + i + 1
            m = replay_step(trainer, batch)
            rows.append(m)
            bad = [k for k in LOSS_TERMS if not np.isfinite(m[k])]
            if i % health_every == 0 or bad:
                params, bn = weight_health(state.student)
                print(f"iter {it}: loss={m['loss']:.4f} "
                      f"sup={m['sup_loss']:.4f} "
                      f"ul={m['unsup_loss_ul']:.4f} "
                      f"lu={m['unsup_loss_lu']:.4f} "
                      f"s={m['unsup_loss_s']:.4f} "
                      f"mask={m['mask_ratio']:.3f} "
                      f"|param|max={max(params.values()):.3e} "
                      f"|bn|max={max(bn.values()):.3e}", flush=True)
            if bad:
                print(f"\n=== first non-finite at iter {it}: {bad} ===")
                print(f"step {place + 1} of call {call + 1} since the "
                      f"snapshot (unroll {unroll})")
                # back to the step before: the snapshot, then the steps
                # that passed, again (the step is deterministic)
                restore(trainer, snap["state"])
                for _, _, b in batches[:i]:
                    replay_step(trainer, b)
                out = os.path.join(dump, "prefail.pt")
                ckpt.atomic_save(out, {"iter": it - 1, "batch": batch,
                                       "state": trainer.host_payload(
                                           state.epoch)})
                print("pre-fail state written to", out, flush=True)
                dissect(trainer, batch)
                return it, rows
        if snap.get("world", 1) > 1:
            print(f"replay finished with no non-finite loss: the dump "
                  f"comes from {snap['world']} ranks, which one process "
                  "matches only within float summation order", flush=True)
        else:
            print("replay finished with no non-finite loss: the step "
                  "should be deterministic, so this is a fault of the "
                  "replay or of the dump", flush=True)
        return None, rows
    finally:
        trainer.close()


def restore(trainer, payload):
    """A snapshot back into the trainer: state, epoch and samplers."""
    ckpt.restore_state(trainer.state, payload)
    trainer.state.epoch = payload["epoch"]
    trainer.lb_pipe.load_state(payload["samplers"]["lb"])
    trainer.ulb_pipe.load_state(payload["samplers"]["ulb"])


def replay_step(trainer, batch):
    """One dumped batch through the step (the LQ reset first where the
    batch opened an epoch, as trainer.new_epoch does); its metrics."""
    state = trainer.state
    if batch["epoch"] != state.epoch:
        reset_epoch(state, batch["epoch"])
    metrics = step_fn(state, trainer.device_data, on_device(trainer, batch),
                      trainer.hp)
    return unpack_metrics(metrics.cpu().numpy(), trainer.hp)


def on_device(trainer, batch):
    return {k: batch[k].to(trainer.device) for k in ("lb_idx", "ulb_idx")}


def stat(name, x):
    x = x.detach().float().cpu()
    fin = torch.isfinite(x)
    top = x[fin].abs().max().item() if fin.any() else float("nan")
    print(f"  {name}: shape={tuple(x.shape)} max|.|={top:.4e} "
          f"nonfinite={int((~fin).sum())}", flush=True)


def nonfinite_names(model):
    return [n for n, t in list(model.named_parameters())
            + list(model.named_buffers())
            if t.is_floating_point() and not torch.isfinite(t).all()]


def dissect(trainer, batch):
    """The failing step taken apart from the trainer's state (the state
    before it): inputs, logits, non-finite tensors, queue and LQ health,
    the first module with a non-finite output and autograd's anomaly
    report of the backward."""
    state, hp = trainer.state, trainer.hp
    print("  student nonfinite:", nonfinite_names(state.student) or "none")
    print("  teacher nonfinite:", nonfinite_names(state.teacher) or "none")
    lq, queue = state.lq, state.queue
    print("  lq.valid:", bool(lq.valid), end="")
    stat(" lq.img", lq.img)
    stat("queue.img", queue.img)
    stat("queue.conf", queue.conf)
    stat("queue.hardness", queue.hardness)
    print(f"  queue.count: {int(queue.count)}  choice_th: "
          f"{float(state.choice_th)}", flush=True)

    first, logits, hooks = [], {}, []

    def watch(name):
        def hook(module, args, out):
            if not first and torch.is_tensor(out) and out.is_floating_point() \
                    and not torch.isfinite(out).all():
                first.append(name)
        return hook

    for role, model in (("teacher", state.teacher),
                        ("student", state.student)):
        for name, module in model.named_modules():
            hooks.append(module.register_forward_hook(
                watch(f"{role}.{name}" if name else role)))
        hooks.append(model.register_forward_hook(
            lambda m, a, out, role=role: logits.__setitem__(role, out)))
    try:
        with torch.autograd.detect_anomaly():
            inp = build_inputs(state, trainer.device_data,
                               on_device(trainer, batch), hp,
                               feed=host_to_device(draw_feed(state, hp),
                                                   trainer.device))
            for k in ("lb_x_w", "ulb_x_w", "ulb_x_s", "ulb_x_s_ul",
                      "ulb_x_s_lu", "lq_s"):
                stat(k, inp[k])
            stat("teacher logits (ulb_w, ul, lu)", logits["teacher"])
            state.optimizer.zero_grad(set_to_none=True)
            loss, aux = loss_terms(state, inp, hp)
            stat("student logits (ulb_w, lb, ul, lu, s, lq)",
                 logits["student"])
            print("  loss terms: " + " ".join(
                f"{k}={float(aux[k].detach()):.4e}" for k in
                ("sup_loss", "unsup_ul", "unsup_lu", "unsup_s"))
                + f" total={float(loss.detach()):.4e}", flush=True)
            try:
                loss.backward()
                print("  detect_anomaly: the backward raised nothing")
            except RuntimeError as e:
                print("  detect_anomaly:", str(e).splitlines()[0])
    finally:
        for h in hooks:
            h.remove()
    print("first non-finite module output:",
          first[0] if first else "none (the forward is finite)", flush=True)
    return first[0] if first else None


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
