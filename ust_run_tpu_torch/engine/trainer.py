"""The training loop, evaluation and checkpoints (port of
ust_run_tpu/engine/trainer.py).

  * datasets and samplers with the reference's split semantics
    (train.py:464-494);
  * the decoded corpus goes to the device once; each step receives only
    the sampled indices (trainer.py:123-135);
  * the epoch loop: num_eval_iter steps per epoch, LQ reset at epoch start
    (train.py:576), epoch-end curriculum summaries (train.py:888-907);
  * `--unroll_steps K` (trainer.py:111-121): K steps per call of
    `semisup.step.multi_step` when K > 1 divides num_eval_iter, else one
    eager `step_fn` per call. A call takes K index batches and K feeds,
    each stacked and copied to the device through pinned memory in one
    copy; on the card it replays a CUDA graph of the step (captured in
    the first call), on the CPU and with a mesh it runs K eager steps;
  * per-step logging with the reference's tag names (train.py:859-870).
    The packed metrics of a call (K rows) are copied to pinned host
    memory without blocking and read one call later, so the host never
    waits on the call it has just queued (trainer.py:274-282, 329-349);
  * EMA and student evaluation every epoch with best-dice tracking and
    the best-student snapshot (train.py:913-954; trainer.py:463-532);
  * the rolling checkpoint, written by a worker thread from a host copy,
    and `--load` resume (train.py:542-548, 955-958);
  * data parallelism (trainer.py:104-110): with a `parallel.Mesh`,
    one process per rank on cuda:LOCAL_RANK (or the device `--device`
    names), both models' BatchNorm synchronised over the ranks, each step
    sharded as parallel/mesh.py sets out and the evaluation split over
    the ranks. Every rank holds the same state and restores `--load`;
    rank 0 alone writes the log, the metric writer and the checkpoints;
  * run control and forensics (trainer.py:158-166, 242-323, 351-389):
    `UST_STOP_AFTER_ITERS=N` ends the run after the first epoch that
    reaches iteration N, without changing `max_iterations` (so the lr,
    ramp and FDA schedules stay those of the full budget);
    `UST_WNORM_LOG=1` logs each top-level module's largest |parameter|
    and |BN statistic| every epoch; `UST_NAN_DEBUG=DIR` keeps a host
    snapshot of the train state every `UST_NAN_SNAP` iterations (default
    250, taken before a call) and the index batches since (each call's,
    (K, B)), and at the first non-finite loss term writes both to DIR
    (`state.pt`, `batches.pt` with the run's `unroll`; replayed by
    `python -m ust_run_tpu_torch.nan_replay`) and exits with code 3;
    `--profile_dir` writes a torch.profiler Chrome trace of the first
    epoch's calls 2-3 (steps 2-3 at unroll 1; one file per rank), where
    the port's spans (utils/trace.py) name host ranges: `call.*` on
    every path, the step's `step.*` only where a step runs eagerly (a
    replay runs none of the step's Python); on a terminal a tqdm bar
    shows the last drained step. With none of them
    set, the step path is unchanged;
  * at each epoch's end, beside its images/s line, the epoch's device ms
    a step in each clocked span of the step, by path (`graph`: replays
    of the captured step; `eager`), from the stage clock of
    utils/trace.py read after the epoch's last fetch.
"""

import logging
import os
import random
import sys
import time

import numpy as np
import torch

from ust_run_tpu_torch import parallel
from ust_run_tpu_torch.config import TrainConfig
from ust_run_tpu_torch.data.datasets import SegmentationDataset
from ust_run_tpu_torch.data.pipeline import BatchPipeline, TestLoader
from ust_run_tpu_torch.engine import checkpoint as ckpt
from ust_run_tpu_torch.engine.evaluator import Evaluator
from ust_run_tpu_torch.semisup.state import (backbone_arch, build_model,
                                             create_train_state, reset_epoch)
from ust_run_tpu_torch.semisup.step import (HyperParams, draw_feeds,
                                            host_to_device, multi_step,
                                            step_fn, unpack_metrics)
from ust_run_tpu_torch.utils import trace
from ust_run_tpu_torch.utils.device import resolve_device
from ust_run_tpu_torch.utils.logging_utils import MetricWriter
from ust_run_tpu_torch.utils.meters import AverageMeter


LOSS_TERMS = ("loss", "sup_loss", "unsup_loss_ul", "unsup_loss_lu",
              "unsup_loss_s")


def set_numerics(deterministic=1, seed=None):
    """float32 matrix products and convolutions in full float32 (no TF32):
    the band-matrix smoothing of the elastic fields must be float32, and
    amp=0 runs should be float32 throughout. bf16 work comes from autocast
    (amp=1) alone.

    `deterministic` is --deterministic (upstream's bootstrap): at 1, the
    default, cuDNN runs only deterministic algorithms and does not
    benchmark, so a step from one state gives the same bits every run, and
    with `seed` the global `random` and `np.random` are seeded as
    ust_run_tpu/cli.py:69-71 seeds them; at 0 cuDNN benchmarks and picks
    the fastest algorithm, deterministic or not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = bool(deterministic)
    torch.backends.cudnn.benchmark = not deterministic
    if deterministic and seed is not None:
        random.seed(seed)
        np.random.seed(seed)


def unroll_of(cfg):
    """Steps per call: --unroll_steps when it is above 1 and divides
    num_eval_iter, else 1 (trainer.py:113-115)."""
    k = cfg.unroll_steps
    return k if k > 1 and cfg.num_eval_iter % k == 0 else 1


class Pending:
    """One call's packed metrics on their way to the host (`it`: the
    iteration of its first row): a CUDA tensor is copied to pinned memory
    without blocking, and `fetch` waits on an event recorded after the
    copy (not a synchronising call)."""

    def __init__(self, it, metrics, ulb_idx):
        self.it = it
        self.ulb_idx = ulb_idx
        if metrics.device.type == "cuda":
            self.host = torch.empty(metrics.shape, dtype=metrics.dtype,
                                    pin_memory=True)
            self.host.copy_(metrics, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = metrics, None

    def fetch(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def indices_to_device(idx, device):
    """{name: host index array} -> {name: int64 tensor on `device`}; to a
    CUDA device through pinned memory without blocking."""
    return {k: host_to_device(np.asarray(v, np.int64), device)
            for k, v in idx.items()}


class Trainer:
    def __init__(self, cfg: TrainConfig, snapshot_path, mesh=None):
        if cfg.model == "unet2d_dsbn":
            # DSBN picks its statistics by a per-call domain label, which
            # the step never supplies (unet2d.py:58): the JAX package
            # cannot train it either (tests/test_model_zoo_step.py:11-13)
            raise ValueError(
                "--model unet2d_dsbn cannot train: its DomainSpecific"
                "BatchNorm2d layers need a domain_label that the SSL step "
                "does not pass; build it with build_model and call it with "
                "one")
        parallel.check_num_devices(cfg.num_devices,
                                   1 if mesh is None else mesh.world)
        self.cfg = cfg
        self.snapshot_path = snapshot_path
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        self.device = resolve_device(cfg.device if mesh is None
                                     else mesh.device)
        set_numerics(cfg.deterministic)
        p = cfg.profile()
        self.profile_ = p
        self.hp = HyperParams.from_config(cfg)
        self.unroll = unroll_of(cfg)

        lb_num = cfg.labeled_count()
        data_num = p.domain_len[cfg.lb_domain - 1]
        domains = list(range(1, cfg.domain_num + 1))
        self.lb_ds = SegmentationDataset(cfg.dataset, p, cfg.data_root,
                                         "train", cfg.lb_domain,
                                         [cfg.lb_domain],
                                         list(range(lb_num)))
        self.ulb_ds = SegmentationDataset(cfg.dataset, p, cfg.data_root,
                                          "train", cfg.lb_domain, domains,
                                          list(range(lb_num, data_num)))
        self.lb_pipe = BatchPipeline(self.lb_ds, cfg.label_bs, seed=cfg.seed)
        self.ulb_pipe = BatchPipeline(self.ulb_ds, cfg.unlabel_bs,
                                      seed=cfg.seed + 1)
        test_loaders = [TestLoader(SegmentationDataset(
            cfg.dataset, p, cfg.data_root, "test", -1, [i]), cfg.eval_batch)
            for i in domains]
        self.evaluator = Evaluator(self.hp, test_loaders, list(p.parts),
                                   self.device, mesh)

        # the decoded corpus goes to the device ONCE; steps receive indices
        corpus = {"lb_img": self.lb_ds.images, "lb_lab": self.lb_ds.labels,
                  "ulb_img": self.ulb_ds.images,
                  "ulb_lab": self.ulb_ds.labels, "ulb_dc": self.ulb_ds.dc}
        self.device_data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in corpus.items()}
        amp = bool(cfg.amp) and self.device.type == "cuda"
        # weights drawn on the CPU, so a seed gives the same models on
        # every device
        init = torch.Generator().manual_seed(cfg.seed)
        student, teacher = (build_model(cfg, self.hp, init, amp)
                            for _ in range(2))
        self.state = create_train_state(self.hp, cfg.seed, self.device,
                                        student, teacher)
        if mesh is not None:
            for model in (self.state.student, self.state.teacher):
                parallel.bind_mesh(model, mesh)
        if cfg.model.startswith("deeplabv2"):
            self._load_pretrained_backbone()
        self.writer = MetricWriter(os.path.join(snapshot_path, "log")) \
            if self.is_main else None

        # best-dice bookkeeping (train.py:526-535)
        n_part = p.n_part
        self.best_dice = [0.0] * n_part
        self.best_dice_iter = [-1] * n_part
        self.best_avg_dice = 0.0
        self.best_avg_dice_iter = -1
        self.dice_of_best_avg = [0.0] * n_part
        self.stu_best_dice = [0.0] * n_part
        self.stu_best_dice_iter = [-1] * n_part
        self.stu_best_avg_dice = 0.0
        self.stu_best_avg_dice_iter = -1
        self.stu_dice_of_best_avg = [0.0] * n_part
        self.start_epoch = 0
        self._ckpt_io = ckpt.AsyncCheckpointer()
        # non-finite-loss forensics (trainer.py:158-166): the last host
        # snapshot (iteration, checkpoint payload) and the batches since
        self._nan_dir = os.environ.get("UST_NAN_DEBUG", "")
        self._nan_snap_every = int(os.environ.get("UST_NAN_SNAP", "250"))
        self._nan_snap = None
        self._nan_batches = []
        self._bar = None
        if cfg.load:
            self._resume(os.path.join(snapshot_path, "checkpoint.pth"))
        self.iter_num = self.state.step
        self._pending = None
        self._meters = None
        self.new_epoch(self.start_epoch)

    def _load_pretrained_backbone(self):
        """ImageNet init of the DeepLab backbone (trainer.py:182-207): the
        user's torchvision-layout `<pretrained_root>/<arch>.pth` (its
        tensors, optionally under `state_dict`; `fc.*` ignored) goes into
        the backbone of BOTH student and teacher; the head stays random.
        Without the file, the JAX package's warning and the random init.
        The port fetches nothing."""
        cfg = self.cfg
        arch = backbone_arch(cfg.model)
        path = os.path.join(cfg.pretrained_root, f"{arch}.pth")
        if not os.path.exists(path):
            logging.warning(
                "pretrained backbone %s not found; training from random "
                "init (the reference would require this file, "
                "resnet.py:185-190). Set --pretrained_root.", path)
            return
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd and not any("conv" in k for k in sd):
            sd = sd["state_dict"]
        sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
        # torchvision's ImageNet files predate num_batches_tracked
        for k, v in self.state.student.backbone.state_dict().items():
            if k.endswith("num_batches_tracked"):
                sd.setdefault(k, v)
        for model in (self.state.student, self.state.teacher):
            ckpt.restore_onto(model.backbone, sd)
        logging.info("loaded ImageNet backbone weights from %s", path)

    def _resume(self, path):
        payload = ckpt.load_checkpoint(path)
        ckpt.restore_state(self.state, payload)
        self.lb_pipe.load_state(payload["samplers"]["lb"])
        self.ulb_pipe.load_state(payload["samplers"]["ulb"])
        self.start_epoch = payload["epoch"]
        self.best_avg_dice = payload["best_dice"]
        self.best_avg_dice_iter = payload["best_iter"]
        self.stu_best_avg_dice = payload["stu_best_dice"]
        self.stu_best_avg_dice_iter = payload["stu_best_iter"]
        logging.info("Models restored from epoch %d", self.start_epoch)

    # ------------------------------------------------------------------
    def _next_batches(self, k):
        """k index batches, stacked: {name: (k, B) int64 numpy}."""
        rows = [{"lb_idx": self.lb_pipe.next_indices(),
                 "ulb_idx": self.ulb_pipe.next_indices()} for _ in range(k)]
        return {name: np.stack([np.asarray(r[name], np.int64) for r in rows])
                for name in rows[0]}

    def new_epoch(self, epoch_num):
        n_part = self.profile_.n_part
        reset_epoch(self.state, epoch_num)
        self._meters = dict(
            hardness=AverageMeter(),
            simple=[AverageMeter() for _ in range(n_part)],
            other=[AverageMeter() for _ in range(n_part)],
            all=[AverageMeter() for _ in range(n_part)],
            lq=[AverageMeter() for _ in range(n_part)],
            dc=np.zeros(self.cfg.domain_num), names={})

    def train_steps(self, n):
        """Run n steps in calls of `unroll` steps (a last shorter call
        takes the rest); returns the unpacked metrics of each step, in
        order. Each call's metrics are read after the next call is
        queued; the last one at the end."""
        out, done = [], 0
        while done < n:
            k = min(self.unroll, n - done)
            if self._nan_dir and (self._nan_snap is None or self.iter_num
                                  - self._nan_snap[0] >= self._nan_snap_every):
                # a snapshot follows a step whose losses were checked
                out += self._flush()
                self._take_snapshot()
            idx = self._next_batches(k)
            if self._nan_dir:
                self._nan_batches.append(
                    {"epoch": self.state.epoch,
                     **{name: torch.from_numpy(v) for name, v in idx.items()}})
            dev_idx = indices_to_device(idx, self.device)
            if self.unroll == 1:
                metrics = step_fn(self.state, self.device_data,
                                  {name: v[0] for name, v in dev_idx.items()},
                                  self.hp, self.mesh)
            else:
                feeds = host_to_device(draw_feeds(self.state, self.hp, k),
                                       self.device)
                metrics = multi_step(self.state, self.device_data, dev_idx,
                                     feeds, self.hp, self.mesh)
            out += self._flush()
            self._pending = Pending(self.iter_num + 1, metrics,
                                    idx["ulb_idx"])
            self.iter_num += k
            done += k
            if self._bar is not None:
                self._bar.update(k)
        return out + self._flush()

    def _flush(self):
        """The pending call's metrics, one per step ([] if there is
        none)."""
        pending, self._pending = self._pending, None
        return [] if pending is None else self._drain(pending)

    def train(self):
        cfg = self.cfg
        parts = list(self.profile_.parts)
        max_epoch = cfg.max_iterations // cfg.num_eval_iter
        stop_after = int(os.environ.get("UST_STOP_AFTER_ITERS", "0"))
        logging.info("%d iterations per epoch", cfg.num_eval_iter)
        logging.info("%d epoch in all.", max_epoch)
        self._stage_mark = self._stage_totals()
        for epoch_num in range(self.start_epoch, max_epoch):
            if epoch_num > self.start_epoch:
                self.new_epoch(epoch_num)
            t0 = time.time()
            self._bar = self._progress_bar(epoch_num)
            if cfg.profile_dir and epoch_num == self.start_epoch:
                self._profiled_steps(cfg.num_eval_iter)
            else:
                self.train_steps(cfg.num_eval_iter)
            if self._bar is not None:
                self._bar.close()
                self._bar = None
            dt = time.time() - t0
            imgs = cfg.num_eval_iter * (cfg.label_bs + cfg.unlabel_bs)
            logging.info("epoch %d: %.1f it/s, %.1f images/s",
                         epoch_num + 1, cfg.num_eval_iter / dt, imgs / dt)
            self._log_stages(epoch_num)
            self._log_epoch(parts)
            if os.environ.get("UST_WNORM_LOG") and self.is_main:
                log_weight_health(epoch_num, self.state.student)
            self.evaluate_and_checkpoint(epoch_num, self.iter_num)
            # a short run on the full budget's schedules (trainer.py:315-323)
            if stop_after and self.iter_num >= stop_after:
                logging.info("UST_STOP_AFTER_ITERS=%d reached at iter %d; "
                             "stopping early", stop_after, self.iter_num)
                break
        self.close()

    def _profiled_steps(self, n):
        """n steps, the 2nd and 3rd call (of `unroll` steps) under
        torch.profiler (trainer.py:253-261), written as a Chrome trace to
        `--profile_dir`, one file per rank."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        k = self.unroll
        self.train_steps(min(n, k))
        # train_steps returns once the last step's metrics have reached the
        # host, so the trace holds all of both calls' device work
        with profile(activities=activities) as prof:
            self.train_steps(min(n - k, 2 * k))
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        rank = 0 if self.mesh is None else self.mesh.rank
        path = os.path.join(self.cfg.profile_dir, f"trace_rank{rank}.json")
        prof.export_chrome_trace(path)
        logging.info("profiler trace written to %s", path)
        self.train_steps(max(n - 3 * k, 0))

    def _stage_totals(self):
        return {path: trace.stage_totals(self.device, path,
                                         trace.STAGES + trace.MODEL_SPANS)
                for path in trace.PATHS}

    def _log_stages(self, epoch_num):
        """The epoch's device ms a step in each clocked span of the step,
        and in each model span that ran in it (TransUNet's `model.vit`),
        on each path that ran steps in it: the stage clock's difference
        since the last mark. Called after the epoch's last fetch, so
        reading the clock adds no wait to a step."""
        now, before = self._stage_totals(), self._stage_mark
        self._stage_mark = now
        parts = []
        for path in trace.PATHS:
            steps = now[path]["step.update"][0] \
                - before[path]["step.update"][0]
            if steps <= 0:
                continue
            ms = ", ".join(
                f"{name.split('.', 1)[1]} "
                f"{1e3 * (sec - before[path][name][1]) / steps:.2f}"
                for name, (n, sec) in now[path].items()
                if name in trace.STAGES or n > before[path][name][0])
            parts.append(f"{path} x{steps}: {ms}")
        if parts:
            logging.info("epoch %d stages, device ms a step: %s",
                         epoch_num + 1, "; ".join(parts))

    def _progress_bar(self, epoch_num):
        """The reference's live tqdm bar (train.py:874-879), on a terminal
        only and where tqdm imports (trainer.py:242-251)."""
        if not (self.is_main and sys.stdout.isatty()):
            return None
        try:
            from tqdm import tqdm
        except ImportError:
            return None
        return tqdm(total=self.cfg.num_eval_iter, ncols=80,
                    desc=f"epoch {epoch_num + 1}", leave=False)

    def close(self):
        """Wait for the last checkpoint write and close the metric log."""
        try:
            self._ckpt_io.close()
        finally:
            if self.writer is not None:
                self.writer.close()

    # ------------------------------------------------------------------
    def _log_epoch(self, parts):
        """Epoch-end curriculum summaries (train.py:888-907)."""
        m = self._meters
        for key, label in (("simple", "epoch simple dice avg"),
                           ("other", "epoch other ulb dice avg"),
                           ("all", "epoch all ulb dice avg"),
                           ("lq", "epoch lq ulb dice avg")):
            for i, pn in enumerate(parts):
                logging.info("%s %s:%f", label, pn, m[key][i].avg)
        logging.info("epoch simple hardness avg:%f", m["hardness"].avg)
        logging.info("choice threshold:%f", float(self.state.choice_th))
        logging.info(" ".join(f"{n} {c}" for n, c in m["names"].items()))
        for i in range(self.cfg.domain_num):
            logging.info("epoch simple domain %d cnt: %d", i + 1,
                         int(m["dc"][i]))

    def _drain(self, pending):
        """A call's rows, step by step (trainer.py:329-349): the NaN check,
        the meters and log lines; the bar shows the last row."""
        arr = pending.fetch().reshape(len(pending.ulb_idx), -1)
        rows = []
        for j, vec in enumerate(arr):
            it = pending.it + j
            m = unpack_metrics(vec, self.hp)
            if self._nan_dir:
                bad = [k for k in LOSS_TERMS if not np.isfinite(m[k])]
                if bad:
                    self._nan_dump(it, bad)
            self._log_step(it, m, pending.ulb_idx[j])
            rows.append(m)
        if self._bar is not None:
            self._bar.set_description(
                bar_description(self.cfg.dataset, it, m), refresh=False)
        return rows

    def _take_snapshot(self):
        """The rolling host snapshot of UST_NAN_DEBUG: the checkpoint
        payload (models, SGD, queue, LQ, choice_th, generators, samplers)
        before the next batch is drawn. Rank 0 alone keeps one."""
        self._nan_batches = []
        self._nan_snap = (self.iter_num, self.host_payload(self.state.epoch)
                          if self.is_main else None)

    def _nan_dump(self, it, bad_terms):
        """First non-finite loss (trainer.py:372-389): rank 0 writes the
        last snapshot and the batches since it for
        `python -m ust_run_tpu_torch.nan_replay`; every rank (the losses
        are replicated) then ends the run with exit code 3."""
        snap_it, payload = self._nan_snap
        if self.is_main:
            os.makedirs(self._nan_dir, exist_ok=True)
            ckpt.atomic_save(os.path.join(self._nan_dir, "state.pt"),
                             {"iter": snap_it, "state": payload,
                              "world": 1 if self.mesh is None
                              else self.mesh.world})
            ckpt.atomic_save(os.path.join(self._nan_dir, "batches.pt"),
                             {"unroll": self.unroll,
                              "batches": self._nan_batches})
            logging.error(
                "non-finite %s at iteration %d; snapshot of iteration %d and "
                "%d batches dumped to %s", ",".join(bad_terms), it, snap_it,
                sum(len(b["lb_idx"]) for b in self._nan_batches),
                self._nan_dir)
        self.close()
        raise SystemExit(3)

    def _log_step(self, it, m, ulb_idx):
        """Per-step meters, scalars and log lines in the JAX trainer's
        format (trainer.py:414-460)."""
        cfg = self.cfg
        mt = self._meters
        parts = list(self.profile_.parts)
        cur_n = int(m["cur_simple_num"])
        if cur_n > 0:
            for i in range(len(parts)):
                mt["simple"][i].update(float(m["cur_simple_dice"][i]))
            mt["hardness"].update(float(m["simple_hardness"]))
            mt["dc"] += m["simple_dc_counts"]
            for i, flag in enumerate(m["simple_flags"]):
                if flag > 0:
                    name = self.ulb_ds.names[int(ulb_idx[i])]
                    mt["names"][name] = mt["names"].get(name, 0) + 1
        if cur_n < cfg.unlabel_bs:
            for i in range(len(parts)):
                mt["other"][i].update(float(m["other_ulb_dice"][i]))
        for i in range(len(parts)):
            mt["all"][i].update(float(m["ulb_dice"][i]))
            mt["lq"][i].update(float(m["lq_dice"][i]))

        w = self.writer
        if w is not None and (it % cfg.log_interval == 0
                              or it % cfg.num_eval_iter == 0):
            for i, pn in enumerate(parts):
                w.add_scalar(f"train/ulb_{pn}_dice", m["ulb_dice"][i], it)
            w.add_scalar("train/mask", m["mask_ratio"], it)
            w.add_scalar("train/lr", m["lr"], it)
            w.add_scalar("train/loss", m["loss"], it)
            w.add_scalar("train/sup_loss", m["sup_loss"], it)
            w.add_scalar("train/unsup_loss_ul", m["unsup_loss_ul"], it)
            w.add_scalar("train/unsup_loss_lu", m["unsup_loss_lu"], it)
            w.add_scalar("train/unsup_loss_s", m["unsup_loss_s"], it)
            w.add_scalar("train/consistency_weight",
                         m["consistency_weight"], it)
            w.add_scalar("train/bi_consistency_weight",
                         float(m["consistency_weight"]) ** 2, it)
        if it % cfg.num_eval_iter == 0:
            logging.info(
                "iteration %d : loss : %f, sup_loss : %f, unsup_loss_ul : %f,"
                " unsup_loss_lu : %f, unsup_loss_s:%.3f,cons_w : %f,"
                " mask_ratio : %f", it, m["loss"], m["sup_loss"],
                m["unsup_loss_ul"], m["unsup_loss_lu"], m["unsup_loss_s"],
                m["consistency_weight"], m["mask_ratio"])
            for i, pn in enumerate(parts):
                logging.info("cur simple dice avg %s:%f", pn,
                             float(m["queue_dice"][i]))

    # ------------------------------------------------------------------
    def evaluate_and_checkpoint(self, epoch_num, iter_num, save=True):
        """EMA then student evaluation with best tracking (trainer.py
        :463-510); with `save`, the best-student snapshot and the rolling
        checkpoint, copied to the host here and written by the worker.
        Returns (ema dice, student dice) per part."""
        parts = list(self.profile_.parts)
        n_part = len(parts)
        logging.info("test ema model")
        val_dice = self.evaluator.run(self.state.teacher, epoch_num + 1,
                                      self.writer, ema=True)
        text = ""
        for i, pn in enumerate(parts):
            if val_dice[i] > self.best_dice[i]:
                self.best_dice[i] = val_dice[i]
                self.best_dice_iter[i] = iter_num
            text += "val_%s_best_dice: %f at %d iter, " % (
                pn, self.best_dice[i], self.best_dice_iter[i])
        if sum(val_dice) / n_part > self.best_avg_dice:
            self.best_avg_dice = sum(val_dice) / n_part
            self.best_avg_dice_iter = iter_num
            self.dice_of_best_avg = list(val_dice)
        text += "val_best_avg_dice: %f at %d iter" % (
            self.best_avg_dice, self.best_avg_dice_iter)
        if n_part > 1:
            for i, pn in enumerate(parts):
                text += ", %s_dice: %f" % (pn, self.dice_of_best_avg[i])
        logging.info(text)

        logging.info("test stu model")
        stu_dice = self.evaluator.run(self.state.student, epoch_num + 1,
                                      self.writer, ema=False)
        text = ""
        for i, pn in enumerate(parts):
            if stu_dice[i] > self.stu_best_dice[i]:
                self.stu_best_dice[i] = stu_dice[i]
                self.stu_best_dice_iter[i] = iter_num
            text += "stu_val_%s_best_dice: %f at %d iter, " % (
                pn, self.stu_best_dice[i], self.stu_best_dice_iter[i])
        is_best = sum(stu_dice) / n_part > self.stu_best_avg_dice
        if is_best:
            self.stu_best_avg_dice = sum(stu_dice) / n_part
            self.stu_best_avg_dice_iter = iter_num
            self.stu_dice_of_best_avg = list(stu_dice)
        text += "val_best_avg_dice: %f at %d iter" % (
            self.stu_best_avg_dice, self.stu_best_avg_dice_iter)
        if n_part > 1:
            for i, pn in enumerate(parts):
                text += ", %s_dice: %f" % (pn, self.stu_dice_of_best_avg[i])
        logging.info(text)

        # --eval reports only and never touches artifacts; rank 0 writes
        if save and self.is_main:
            payload = self.host_payload(epoch_num + 1)
            best = payload["state_dict"] if is_best else None
            self._ckpt_io.submit(self._write_checkpoint, payload, best)
        return val_dice, stu_dice

    def host_payload(self, epoch):
        """The rolling checkpoint's payload of the live state (with the
        best-dice bookkeeping and the samplers), copied to the host."""
        return ckpt.host_copy(ckpt.state_payload(
            self.state, epoch,
            (self.best_avg_dice, self.best_avg_dice_iter,
             self.stu_best_avg_dice, self.stu_best_avg_dice_iter),
            {"lb": self.lb_pipe.state(), "ulb": self.ulb_pipe.state()}))

    def _write_checkpoint(self, payload, best):
        if best is not None:
            path = os.path.join(self.snapshot_path,
                                f"{self.cfg.model}_avg_dice_best_model.pth")
            logging.info("save cur best avg model to %s", path)
            ckpt.atomic_save(path, best)      # a bare student state_dict
        path = os.path.join(self.snapshot_path, "checkpoint.pth")
        ckpt.atomic_save(path, payload)
        logging.info("save checkpoint to %s", path)

    def wait_for_checkpoint(self):
        """Block until the last submitted checkpoint is on disk."""
        self._ckpt_io.wait()


def weight_health(model):
    """({module: max |parameter|}, {module: max |BN running mean or
    variance|}) over `model`'s top-level modules, in sorted order as the
    JAX trainer's variable dicts are (trainer.py:351-370). Parameters
    include the BN weights and biases; `num_batches_tracked` (a count) is
    left out, and so is a module without BN statistics."""
    def maxima(named):
        groups = {}
        for name, t in named:
            groups.setdefault(name.split(".")[0], []).append(
                t.detach().abs().amax())
        return {k: torch.stack(v).amax().item()
                for k, v in sorted(groups.items())}

    return (maxima(model.named_parameters()),
            maxima((n, b) for n, b in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))))


def log_weight_health(epoch_num, model):
    """UST_WNORM_LOG's two lines in the JAX trainer's format: the signal
    of first-layer weights growing until the BN variance overflows
    (STABILITY.md)."""
    params, bn = weight_health(model)
    for what, maxima in (("params", params), ("bn", bn)):
        logging.info("epoch %d weight health: %s max %s", epoch_num + 1,
                     what, " ".join(f"{k}:{v:.3e}" for k, v in maxima.items()))


def bar_description(dataset, it, m):
    """The reference's live tqdm description (train.py:874-879;
    trainer.py:391-412) from the unpacked metrics `m` of iteration
    `it`."""
    if dataset == "fundus":
        return ("iteration %d: loss:%.4f,sup_loss:%.4f, "
                "unsup_loss_ul:%f, unsup_loss_lu:%f, cons_w:%.4f,"
                "mask_ratio:%.4f,%.4f,%.4f,ulb_cd:%.4f,ulb_dd:%.4f"
                % (it, m["loss"], m["sup_loss"], m["unsup_loss_ul"],
                   m["unsup_loss_lu"], m["consistency_weight"],
                   m["mask_ratio"], m["ratio_before_ensemble"],
                   m["ratio_after_ensemble"], m["ulb_dice"][0],
                   m["ulb_dice"][-1]))
    return ("iteration %d : loss:%.3f, sup_loss:%.3f, "
            "unsup_loss_ul:%.3f, unsup_loss_lu:%.3f, "
            "unsup_loss_s:%.3f, cons_w:%.3f, "
            "mask_ratio:%.3f,%.4f,%.4f, ulb_dice:%.3f"
            % (it, m["loss"], m["sup_loss"], m["unsup_loss_ul"],
               m["unsup_loss_lu"], m["unsup_loss_s"],
               m["consistency_weight"], m["mask_ratio"],
               m["ratio_before_ensemble"], m["ratio_after_ensemble"],
               m["ulb_dice"][0]))
