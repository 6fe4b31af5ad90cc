"""Standalone evaluation entry point of the port (counterpart of the
repo's test.py).

    python -m ust_run_tpu_torch.test --dataset fundus --save_name run1 \
        --data_root DIR --model_root DIR [--device cuda]

Flags are those of test.py (the reference's test.py:19-32) plus
`--device` (default cuda; a missing card raises unless `--device cpu` is
given). It builds `--model` (any of the trainer's: unet, unet2d,
deeplabv2, deeplabv2_r50), rebuilds the per-domain test loaders, loads
`<model_root>/<dataset>/<save_name>/<model>_avg_dice_best_model.pth` (the
port's file, upstream's, or the JAX package's pickle, converted for
`--model`; `--load_path` is ignored there too) and runs
one evaluation pass, logged to `test_log.txt` and stdout. `--save_img`
then writes each test image's prediction and ground-truth overlays to
`<snapshot>/pred_images/<name>` (JAX test.py:86-97). Under `torchrun
--nproc_per_node N` the test samples are split over the ranks (every rank
returns the same metrics), rank 0 logs, and each overlay is written once,
by the rank that evaluated its image.
"""

import argparse
import logging
import os
import sys

import torch

from ust_run_tpu_torch.config import TrainConfig
from ust_run_tpu_torch.data.datasets import SegmentationDataset
from ust_run_tpu_torch.data.pipeline import TestLoader
from ust_run_tpu_torch.engine import checkpoint as ckpt
from ust_run_tpu_torch.engine.evaluator import Evaluator
from ust_run_tpu_torch.parallel import init_distributed
from ust_run_tpu_torch.semisup.state import build_model
from ust_run_tpu_torch.semisup.step import HyperParams
from ust_run_tpu_torch.utils import visualize
from ust_run_tpu_torch.utils.device import resolve_device


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="prostate",
                        choices=["fundus", "prostate", "MNMS", "BUSI"])
    parser.add_argument("--save_name", type=str, default="debug")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--model", type=str, default="unet")
    parser.add_argument("--gpu", type=str, default="0")
    parser.add_argument("--eval", type=bool, default=True)
    parser.add_argument("--test_bs", type=int, default=1)
    parser.add_argument("--domain_num", type=int, default=6)
    parser.add_argument("--lb_domain", type=int, default=1)
    parser.add_argument("--save_img", action="store_true")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--model_root", type=str, default="../model")
    parser.add_argument("--eval_batch", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; cuda:LOCAL_RANK under "
                             "torchrun; raises if absent), cuda:N or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)              # raise before touching any file
    mesh = init_distributed(device=args.device)
    try:
        return evaluate(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def evaluate(args, mesh=None):
    """One evaluation pass from parsed flags on `mesh` (None: one
    process); returns the per-part dice."""
    device = resolve_device(args.device if mesh is None else mesh.device)
    cfg = TrainConfig(dataset=args.dataset, save_name=args.save_name,
                      model=args.model, domain_num=args.domain_num,
                      data_root=args.data_root, model_root=args.model_root,
                      eval_batch=args.eval_batch, device=args.device).resolve()
    profile = cfg.profile()
    snapshot_path = os.path.join(cfg.model_root, cfg.dataset,
                                 cfg.save_name) + "/"
    os.makedirs(snapshot_path, exist_ok=True)
    root = logging.getLogger()
    handlers = []
    if mesh is None or mesh.rank == 0:
        root.setLevel(logging.INFO)
        handlers = [logging.FileHandler(snapshot_path + "/test_log.txt"),
                    logging.StreamHandler(sys.stdout)]
    for h in handlers:
        h.setFormatter(logging.Formatter(
            "[%(asctime)s.%(msecs)03d] %(message)s", datefmt="%H:%M:%S"))
        root.addHandler(h)
    try:
        logging.info(" ".join(["python"] + sys.argv))
        loaders = [TestLoader(SegmentationDataset(
            cfg.dataset, profile, cfg.data_root, "test", -1, [i]),
            cfg.eval_batch) for i in range(1, cfg.domain_num + 1)]
        hp = HyperParams.from_config(cfg)
        model = build_model(cfg, hp, torch.Generator().manual_seed(0),
                            amp=bool(cfg.amp) and device.type == "cuda")
        best_path = os.path.join(snapshot_path,
                                 f"{cfg.model}_avg_dice_best_model.pth")
        ckpt.restore_onto(model, ckpt.load_best_model(best_path, cfg.model))
        model = model.to(device, memory_format=torch.channels_last)
        evaluator = Evaluator(hp, loaders, list(profile.parts), device,
                              mesh)
        dice = evaluator.run(model, 1, writer=None, ema=True)
        if args.save_img:
            save_overlays(evaluator, model,
                          os.path.join(snapshot_path, "pred_images"))
        return dice
    finally:
        for h in handlers:
            root.removeHandler(h)
            h.close()


def save_overlays(evaluator, model, out_dir):
    """Every test image of this rank's share (all of them without a mesh):
    its prediction and ground truth overlaid side by side
    (utils/visualize.draw_mask_and_save), in eval mode."""
    model.eval()
    for loader in evaluator.loaders:
        for batch in evaluator.local(loader):
            _, _, pred_parts, mask_parts = evaluator.forward(
                model, batch["image"], batch["label"])
            pp, mp = pred_parts.cpu().numpy(), mask_parts.cpu().numpy()
            for j, name in enumerate(batch["names"]):
                visualize.draw_mask_and_save(batch["image"][j], pp[j], mp[j],
                                             out_dir, name)
    logging.info("saved overlays to %s", out_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
