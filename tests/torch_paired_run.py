"""A paired run of the two packages on the CPU: the JAX trainer's step and
the port's, from the same weights, on the same index batches, each with
its own random draws (augmentation, FDA, CutMix), float32.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_paired_run.py \
        [--steps 300] [--every 10] [--init jax|port] [--seed 1337] \
        [--eval_every 0] [--out FILE.json]

It separates the step's math from its inputs over a run's first epoch
(the fundus lane's flags: `--lb_domain 1 --lb_num 8 --seed S` on the 30k
schedule, the synthetic corpus of `data.synthetic` with its defaults,
decoded at patch 64: the CPU cannot train the full 256 in reasonable
time). Both start from the initial weights that
`--init`'s package draws at the seed (the JAX trainer's, or the port's,
carried across by convert.py or ust_run_tpu.utils.torch_import). Every
`--every` steps it records, for each package:
  * the first layer's (`inc`) BN running mean and variance, max |.|, and
    each top-level module's max |BN statistic| (the weight-health line);
  * the range of the inputs that the step's `build_inputs` made: mean,
    standard deviation, mean square, min and max of the weak (`lb_x_w`,
    `ulb_x_w`) and strong (`ulb_x_s`, `ulb_x_s_ul`, `ulb_x_s_lu`,
    `lq_s`) batches;
  * the loss.
Every `--eval_every` steps (0: never) it also evaluates both packages'
teacher (EMA) and student on the synthetic test split, each through its
own trainer's evaluator at the same patch, and records the average dice.
The indices come from the port's samplers and go to both steps. The
draws differ (the frameworks' RNG streams differ), so the two columns
agree in distribution, not value: a statistic that drifts apart over the
run points at the inputs if the input ranges differ too, and at the step
if they do not. Prints one table row per record and writes the records
as JSON to `--out`.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ust_run_tpu import config as jcfg
from ust_run_tpu.engine.trainer import Trainer as JaxTrainer
from ust_run_tpu.semisup.step import make_step_parts
from ust_run_tpu.utils.torch_import import unet_from_torch_state_dict
from ust_run_tpu_torch import config as pcfg
from ust_run_tpu_torch.convert import unet_state_dict_from_jax
from ust_run_tpu_torch.data.synthetic import generate
from ust_run_tpu_torch.engine.trainer import (Trainer, indices_to_device,
                                              weight_health)
from ust_run_tpu_torch.semisup import step as pstep

PATCH = 64
INPUTS = ("lb_x_w", "ulb_x_w", "ulb_x_s", "ulb_x_s_ul", "ulb_x_s_lu",
          "lq_s")


def input_stats(x):
    x = np.asarray(x, np.float64)
    return {"mean": x.mean(), "std": x.std(), "ms": (x * x).mean(),
            "min": x.min(), "max": x.max()}


def jax_bn_max(batch_stats):
    """{module: max |BN statistic|}, and inc's (mean, var) maxima."""
    mods = {k: max(float(jnp.max(jnp.abs(v)))
                   for v in jax.tree.leaves(t))
            for k, t in sorted(batch_stats.items())}
    inc = {"mean": 0.0, "var": 0.0}
    for path, v in jax.tree_util.tree_leaves_with_path(batch_stats["inc"]):
        kind = "var" if "var" in jax.tree_util.keystr(path) else "mean"
        inc[kind] = max(inc[kind], float(jnp.max(jnp.abs(v))))
    return mods, inc


def port_bn_max(model):
    inc = {"mean": 0.0, "var": 0.0}
    for name, t in model.inc.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            kind = "var" if name.endswith("var") else "mean"
            inc[kind] = max(inc[kind], t.abs().max().item())
    return weight_health(model)[1], inc


def paired_run(root, workdir, steps, patch, every, init="jax", seed=1337,
               eval_every=0):
    argv = ["--dataset", "fundus", "--lb_domain", "1", "--lb_num", "8",
            "--seed", str(seed), "--num_eval_iter", "500", "--eval_batch", "4",
            "--amp", "0", "--unroll_steps", "1", "--patch_override",
            str(patch), "--data_root", root]
    jt = JaxTrainer(jcfg.config_from_args(
        jcfg.build_parser("fundus").parse_args(argv)).resolve(),
        os.path.join(workdir, "jax"), use_mesh=False)
    pt = Trainer(pcfg.config_from_args(pcfg.build_parser("fundus").parse_args(
        argv + ["--device", "cpu"])).resolve(), os.path.join(workdir, "port"))
    js = jt.state
    ps = pt.state
    if init == "port":
        stu, tea = (unet_from_torch_state_dict(m.state_dict())
                    for m in (ps.student, ps.teacher))
        js = js.replace(params=stu["params"], batch_stats=stu["batch_stats"],
                        ema_params=tea["params"],
                        ema_batch_stats=tea["batch_stats"],
                        opt_state=jt.state.opt_state)
    else:
        ps.student.load_state_dict(unet_state_dict_from_jax(
            {"params": js.params, "batch_stats": js.batch_stats}))
        ps.teacher.load_state_dict(unet_state_dict_from_jax(
            {"params": js.ema_params, "batch_stats": js.ema_batch_stats}))
    step_j, build_j, _ = make_step_parts(jt.model, jt.hp)
    step_j, build_j = jax.jit(step_j), jax.jit(build_j)

    made = {}

    def recording(*a, **k):
        made["inp"] = build_inputs(*a, **k)
        return made["inp"]

    build_inputs = pstep.build_inputs
    pstep.build_inputs = recording
    def evaluate(it):
        """Average dice of each package's teacher (EMA) and student."""
        return {"jax": {k: float(np.mean(jt.evaluator.run(p, b, it,
                                                         ema=k == "ema")))
                        for k, p, b in (("ema", js.ema_params,
                                         js.ema_batch_stats),
                                        ("stu", js.params, js.batch_stats))},
                "port": {k: float(np.mean(pt.evaluator.run(m, it,
                                                           ema=k == "ema")))
                         for k, m in (("ema", ps.teacher),
                                      ("stu", ps.student))}}

    records = []
    try:
        for it in range(steps + 1):
            if it % every == 0 or it == steps:
                (jmods, jinc), (pmods, pinc) = (jax_bn_max(js.batch_stats),
                                                port_bn_max(ps.student))
                records.append({"iter": it, "jax": {"bn": jmods, "inc": jinc},
                                "port": {"bn": pmods, "inc": pinc}})
            if eval_every and it and (it % eval_every == 0 or it == steps):
                if records[-1]["iter"] != it:
                    records.append({"iter": it, "jax": {}, "port": {}})
                dice = evaluate(it)
                for w in ("jax", "port"):
                    records[-1][w]["dice"] = dice[w]
            if it == steps:
                break
            idx = {k: v[0] for k, v in pt._next_batches(1).items()}
            dev_idx = indices_to_device(idx, pt.device)
            jidx = {k: np.asarray(v, np.int32) for k, v in idx.items()}
            record = records[-1]["iter"] == it
            if record:
                jinp = build_j(js, jt.device_data, jidx)
            js, jm = step_j(js, jt.device_data, jidx)
            pm = pstep.step_fn(ps, pt.device_data, dev_idx, pt.hp)
            if record:
                rec = records[-1]
                rec["jax"]["inputs"] = {k: input_stats(jinp[k])
                                        for k in INPUTS}
                rec["port"]["inputs"] = {
                    k: input_stats(made["inp"][k].detach().numpy())
                    for k in INPUTS}
                rec["jax"]["loss"] = float(np.asarray(jm)[0])
                rec["port"]["loss"] = float(pm[0])
    finally:
        pstep.build_inputs = build_inputs
        jt.writer.close()
        pt.close()
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--init", choices=("jax", "port"), default="jax")
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--eval_every", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as work:
        root = generate("fundus", os.path.join(work, "data"))
        records = paired_run(root, work, args.steps, PATCH, args.every,
                             args.init, args.seed, args.eval_every)
    print("| iter | inc var max JAX / port | inc mean max JAX / port | "
          "bn max module JAX / port | loss JAX / port |")
    print("|---|---|---|---|---|")
    for r in records:
        j, p = r["jax"], r["port"]
        if "bn" not in j:
            continue
        top = [max(x["bn"], key=x["bn"].get) for x in (j, p)]
        loss = (f"{j['loss']:.4f} / {p['loss']:.4f}" if "loss" in j
                else "-")
        print(f"| {r['iter']} | {j['inc']['var']:.4f} / "
              f"{p['inc']['var']:.4f} | {j['inc']['mean']:.4f} / "
              f"{p['inc']['mean']:.4f} | {top[0]} {j['bn'][top[0]]:.3f} / "
              f"{top[1]} {p['bn'][top[1]]:.3f} | {loss} |")
    print("\ninputs over the recorded steps (mean of each statistic), "
          "JAX / port:")
    rows = [r for r in records if "inputs" in r["jax"]]
    for k in INPUTS:
        cells = []
        for s in ("mean", "std", "ms", "min", "max"):
            a, b = (np.mean([r[w]["inputs"][k][s] for r in rows])
                    for w in ("jax", "port"))
            cells.append(f"{s} {a:.4f} / {b:.4f}")
        print(f"  {k}: " + ", ".join(cells))
    evals = [r for r in records if "dice" in r["jax"]]
    if evals:
        print("\n| seed | iteration | JAX EMA / port EMA | "
              "JAX student / port student | up4 BN max JAX / port |")
        print("|---|---|---|---|---|")
        for r in evals:
            j, p = r["jax"], r["port"]
            up4 = (f"{j['bn']['up4']:.4f} / {p['bn']['up4']:.4f}"
                   if "bn" in j else "-")
            print(f"| {args.seed} | {r['iter']} | {j['dice']['ema']:.4f} / "
                  f"{p['dice']['ema']:.4f} | {j['dice']['stu']:.4f} / "
                  f"{p['dice']['stu']:.4f} | {up4} |")
    print(f"\n{args.steps} steps at patch {PATCH}, seed {args.seed}, "
          f"{args.init}'s initial weights: "
          f"{time.time() - t0:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
