"""Per-domain evaluation (port of ust_run_tpu/engine/evaluator.py).

Capability parity with the reference `test()` (train.py:253-395; test.py
:64-195):

  * per-domain loop over the test loaders, dataset-specific mask decode;
  * smoothed Dice per part (the reference formula), averaged per domain
    then across domains;
  * boundary metrics dc/jc/hd95/asd per sample per part, with hd = asd =
    100 when the prediction is empty (train.py:313-315);
  * scalars to the metric writer and the text summary to the log, in the
    JAX evaluator's format and tags;
  * returns the per-part val dice list for best-model tracking.

The forward runs in eval mode (running BN statistics) under
`torch.no_grad` on the model's device, on fixed padded batches; dice and
the loss are per sample, so a padded tail batch contributes exactly what
the reference's batch-size-1 loop does. Only the boolean maps the boundary
metrics need go to the host, and their C++ engine runs on one worker
thread while the main thread queues the next batch's forward.

With a data-parallel `mesh`, each rank evaluates a contiguous share of
each domain's samples in padded batches of its own (the counterpart of
the JAX evaluator's padded sharded batches, evaluator.py:51-68); the
per-domain sums of per-sample loss, dice and boundary metrics and the
sample counts go through one all-reduce, so every rank holds the means
one process computes.
"""

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ust_run_tpu_torch.ops import augment
from ust_run_tpu_torch.semisup.step import decode_mask
from ust_run_tpu_torch.utils import losses as L
from ust_run_tpu_torch.utils import metrics as M
from ust_run_tpu_torch.utils.boundary_native import boundary_metrics


class Evaluator:
    def __init__(self, hp, test_loaders, parts, device, mesh=None):
        self.hp = hp
        self.loaders = test_loaders
        self.parts = parts
        self.n_part = len(parts)
        self.device = torch.device(device)
        self.mesh = mesh

    def local(self, loader):
        """The loader over this rank's share of the samples."""
        if self.mesh is None:
            return loader
        return loader.shard(self.mesh.rank, self.mesh.world)

    @torch.no_grad()
    def forward(self, model, img_u8, lab_u8):
        """One padded batch (uint8 numpy NHWC) through `model` in its
        current mode -> (dice (P,B), per-sample loss (B,), pred_parts,
        mask_parts (B,S,S,P) bool), all on the device (evaluator.py
        :71-101)."""
        hp = self.hp
        img = torch.from_numpy(np.ascontiguousarray(img_u8)).to(self.device)
        lab = torch.from_numpy(np.ascontiguousarray(lab_u8)).to(self.device)
        logits = model(augment.normalize(img.to(torch.float32)))
        mask = decode_mask(lab, hp.dataset)
        # per-sample loss: the reference evaluates with batch_size=1
        # (train.py:289-290), so the per-domain mean is over samples
        loss = torch.stack([
            L.ce_plus_dice(logits[i:i + 1], mask[i:i + 1],
                           multilabel=hp.multilabel, n_classes=hp.num_classes)
            for i in range(logits.shape[0])])
        if hp.multilabel:
            pred = torch.sigmoid(logits) >= 0.5                  # train.py:293
            dice = M.dice_per_part(pred, mask, self.n_part)
            return dice, loss, pred, mask > 0.5
        pred = torch.argmax(torch.softmax(logits, dim=-1), dim=-1)   # :297
        if self.n_part == 1:
            dice = M.dice_per_part(pred == 1, mask == 1, 1)
            return dice, loss, (pred == 1)[..., None], (mask == 1)[..., None]
        dice = M.dice_per_part(pred, mask, self.n_part)
        classes = range(1, self.n_part + 1)
        return (dice, loss, torch.stack([pred == c for c in classes], dim=-1),
                torch.stack([mask == c for c in classes], dim=-1))

    def _boundary_task(self, pred_parts, mask_parts):
        """Host-side EDT metrics of one batch's valid samples; runs on the
        worker thread (the ctypes call releases the GIL)."""
        acc = np.zeros((4, self.n_part))
        for j in range(pred_parts.shape[0]):
            for i in range(self.n_part):
                p = pred_parts[j, ..., i]
                d, jcc, hd, asd_v = boundary_metrics(p, mask_parts[j, ..., i])
                acc[0, i] += d
                acc[1, i] += jcc
                if p.sum() < 1e-4:                          # train.py:313
                    acc[2, i] += 100
                    acc[3, i] += 100
                else:
                    acc[2, i] += hd
                    acc[3, i] += asd_v
        return acc

    def run(self, model, epoch, writer=None, ema=True):
        """Evaluate `model`; returns the per-part val dice averaged over
        domains (train.py:368-395)."""
        return [float(v) for v in self.evaluate(model, epoch, writer,
                                                ema)["metrics"][0]]

    def evaluate(self, model, epoch, writer=None, ema=True):
        """Evaluate `model` (put in eval mode for the pass, its mode
        restored after), log and write scalars; returns {"loss",
        "metrics"} averaged over domains, with metrics a (5, n_part) array
        of dice, dc, jc, hd95, asd, and "domains", the same per domain."""
        was_training = model.training
        model.eval()
        try:
            with ThreadPoolExecutor(max_workers=1) as pool:
                return self._run(model, epoch, writer, ema, pool)
        finally:
            model.train(was_training)

    def _run(self, model, epoch, writer, ema, pool):
        model_name = "ema" if ema else "stu"
        np_ = self.n_part
        # per domain: the sums of dice, dc, jc, hd, asd, loss; the count
        sums = np.zeros((len(self.loaders), 5 * np_ + 2))
        for d_i, loader in enumerate(self.loaders):
            dom = np.zeros((5, np_))
            dom_loss = 0.0
            n = 0
            futures = []
            for batch in self.local(loader):
                valid = batch["valid"]
                dice, loss, pred_parts, mask_parts = self.forward(
                    model, batch["image"], batch["label"])
                vt = torch.from_numpy(valid).to(self.device)
                dom[0] += dice[:, vt].sum(dim=1).double().cpu().numpy()
                dom_loss += float(loss[vt].double().sum())        # exact
                n += int(valid.sum())
                futures.append(pool.submit(
                    self._boundary_task, pred_parts[vt].cpu().numpy(),
                    mask_parts[vt].cpu().numpy()))
            for f in futures:
                dom[1:] += f.result()
            sums[d_i] = np.concatenate([dom.ravel(), [dom_loss, n]])
        if self.mesh is not None:
            sums = self.mesh.sum_numpy(sums)

        val = np.zeros((5, np_))        # dice, dc, jc, hd, asd
        val_loss = 0.0
        domains = []
        for d_i, row in enumerate(sums):
            domain_code = d_i + 1
            n = row[-1]
            dom = row[:5 * np_].reshape(5, np_) / n
            dom_loss = row[-2] / max(n, 1)
            domains.append({"loss": dom_loss, "metrics": dom})
            val += dom
            val_loss += dom_loss
            if writer is not None:
                writer.add_scalar(
                    f"{model_name}_val/domain{domain_code}/loss", dom_loss,
                    epoch)
                for i, p in enumerate(self.parts):
                    writer.add_scalar(
                        f"{model_name}_val/domain{domain_code}/val_{p}_dice",
                        dom[0, i], epoch)
            logging.info(self._text(f"domain{domain_code} epoch {epoch}",
                                    dom_loss, dom))
        val /= len(self.loaders)
        val_loss /= len(self.loaders)
        if writer is not None:
            writer.add_scalar(f"{model_name}_val/loss", val_loss, epoch)
            for i, p in enumerate(self.parts):
                writer.add_scalar(f"{model_name}_val/val_{p}_dice",
                                  val[0, i], epoch)
        logging.info(self._text(f"epoch {epoch}", val_loss, val))
        return {"loss": val_loss, "metrics": val, "domains": domains}

    def _text(self, head, loss, m):
        """The JAX evaluator's summary block (evaluator.py:194-211)."""
        text = "%s : loss : %f" % (head, loss)
        for row, name, sep in ((0, "dice", "\n\t"), (1, "dc", "\n\t"),
                               (2, "jc", "\t"), (3, "hd", "\n\t"),
                               (4, "asd", "\t")):
            text += sep
            for i, p in enumerate(self.parts):
                text += "val_%s_%s: %f, " % (p, name, m[row, i])
        return text
