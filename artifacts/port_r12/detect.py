"""Which operators of one eager SSL step have no deterministic CUDA
implementation, and whether two eager steps from one state agree, for
the port in TREE (default: this checkout) on one card:

    python artifacts/port_r12/detect.py [TREE]

For --model deeplabv2_r50, unet2d and unet (fundus, full width, random
weights from the trainer's seed): one warm-up step, then one step under
torch.use_deterministic_algorithms(True, warn_only=True), printing each
distinct warning (an operator PyTorch knows to add with atomics, with no
deterministic alternative); then, from the state after it, the same step
twice (the state restored in place between them), printing the state
tensors and metrics that differ and the largest difference as a share of
the step's update."""

import math
import os
import shutil
import sys
import warnings

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, TREE)

import torch  # noqa: E402

from ust_run_tpu_torch.config import build_parser, config_from_args  # noqa
from ust_run_tpu_torch.data.synthetic import generate  # noqa: E402
from ust_run_tpu_torch.engine.trainer import Trainer, set_numerics  # noqa
from ust_run_tpu_torch.nan_replay import restore  # noqa: E402


def tensors(state):
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    out.update({f"momentum.{i}": s["momentum_buffer"] for i, s in
                state.optimizer.state_dict()["state"].items()})
    return {k: v.detach().to("cpu", copy=True) for k, v in out.items()}


def main():
    set_numerics()
    work = os.path.join(TREE, "_detect")
    shutil.rmtree(work, ignore_errors=True)
    root = generate("fundus", os.path.join(work, "fundus"), n_train=8,
                    n_test=2, size=256, seed=0)
    for model in ("deeplabv2_r50", "unet2d", "unet"):
        argv = ["--dataset", "fundus", "--data_root", root, "--lb_domain",
                "1", "--lb_num", "4", "--save_name", model, "--overwrite",
                "--model_root", os.path.join(work, "m"), "--device", "cuda",
                "--model", model, "--unroll_steps", "1", "--pretrained_root",
                os.path.join(work, "none")]
        cfg = config_from_args(build_parser().parse_args(argv)).resolve()
        tr = Trainer(cfg, os.path.join(work, "m", model) + "/")
        tr.train_steps(1)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                tr.train_steps(1)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        flagged = sorted({str(w.message).split(" does not have")[0]
                          for w in rec if "deterministic" in str(w.message)})
        print(f"[detect] {model}: {len(rec)} warnings; operators without "
              f"a deterministic implementation: {flagged or 'none'}",
              flush=True)
        start = tensors(tr.state)
        before = tr.host_payload(tr.state.epoch)
        runs = []
        for _ in range(2):
            restore(tr, before)
            tr.iter_num = tr.state.step
            rows = tr.train_steps(1)
            runs.append((rows[0], tensors(tr.state)))
        (m1, s1), (m2, s2) = runs
        rows = [k for k in m1 if not (m1[k] == m2[k]).all()]
        diff = [k for k in s1 if not torch.equal(s1[k], s2[k])]
        d = moved = 0.0
        for k in s1:
            if s1[k].is_floating_point():
                d += float((s1[k].double() - s2[k].double()).square().sum())
                moved += float((s1[k].double() - start[k].double())
                               .square().sum())
        print(f"[detect] {model}: two eager steps from one state: "
              f"{len(diff)} of {len(s1)} state tensors and {len(rows)} "
              f"metrics differ; ||d|| / ||update|| "
              f"{math.sqrt(d / max(moved, 1e-300)):.3e}", flush=True)
        tr.close()
        del tr
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
