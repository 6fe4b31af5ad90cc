"""One run of a training cell, in the pieces that `run.py` (the timed run)
and `readings.py` (the readings limits are set from) share.

`start` makes the weights and the corpus from the seed on the device,
builds the program around them and drives it through the cell's first
`checked_steps` steps, each through the cell's own call on rows that all
differ, keeping on the host what the comparison needs. The same object
then goes on to the warm-up and the window. `reference` runs the plain
reference over the same steps, after the program's state is freed.
"""

import numpy as np
import torch

from benchmarks import check, traffic, weights
from benchmarks.program import LOSS_COLUMN, Program
from benchmarks.reference import models as ref_models
from benchmarks.reference.step import Hyper, ReferenceStep


def _host(tensors):
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def make_inputs(config, cell, seed, device):
    """(student and teacher state_dicts, corpus) drawn on `device` from
    one generator seeded with `seed`, in that order."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        structure = ref_models.build(config)
    sds = weights.make_state_dicts(structure, config["model"]["family"], g)
    data = traffic.make_corpus(g, cell["corpus_images"], config["patch"],
                               config["channels"], config["label_channels"],
                               device)
    return sds, data


class Started:
    """The program after its checked steps, with its corpus, index stream
    and the host copies the comparison reads."""

    def __init__(self, config, cell, seed, device, program_cls=Program):
        self.config, self.cell, self.seed = config, cell, seed
        sds, self.data = make_inputs(config, cell, seed, device)
        self.program = program_cls(config, cell, seed, device, sds)
        del sds
        self.stream = traffic.IndexStream(seed, cell["corpus_images"],
                                          cell["label_bs"],
                                          cell["unlabel_bs"])
        n = cell["checked_steps"]
        self.first = self.stream.first(n)
        init = _host(self.program.leaves())
        mu = config["training"]["momentum"]
        wd = config["training"]["weight_decay"]
        weights_before = init
        losses, grads, before = [], [], None
        for i in range(n):
            m = self.program.call(self.data, {k: v[i:i + 1] for k, v in
                                              self.first.items()})
            losses.append(m[:, LOSS_COLUMN])
            # the gradient the optimizer got: SGD's momentum buffer is
            # mu * buffer + grad + wd * weight
            momentum = _host(self.program.momentum())
            grads.append({k: v - wd * weights_before[f"student.{k}"]
                          - (0.0 if before is None else mu * before[k])
                          for k, v in momentum.items()})
            before = momentum
            if i + 1 < n:
                weights_before = _host(self.program.weights())
        final = _host(self.program.leaves())
        self.losses = torch.cat(losses).cpu().tolist()
        self.trajectory = check.trajectory(self.losses, init, grads, final)

    def free(self):
        """Drop the program's state; the corpus and the rows stay."""
        self.program.close()
        self.program = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference(config, cell, seed, data, first, precision="fp32",
              fault=None):
    """The plain reference's trajectory over the rows `first`, from the
    weights `seed` gives: float32 (`precision` "tf32" lets float32
    products run in TF32; "fp8" rounds the convolutions to float8), with
    cuDNN free to choose algorithms that are not deterministic."""
    device = data["lb_img"].device
    sds, _ = make_inputs(config, cell, seed, device)
    nets = []
    for sd in sds:
        with torch.device("meta"):
            net = ref_models.build(config)
        net = net.to_empty(device=device)
        net.load_state_dict(sd)
        nets.append(ref_models.set_precision(net, precision))
    del sds
    hp = Hyper.of(config, cell)
    ref = ReferenceStep(hp, nets[0], nets[1], seed, device,
                        epoch=cell["epoch"], fault=fault)
    init = {k: v.clone() for k, v in leaves(ref).items()}
    rows = {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in first.items()}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = precision == "tf32"
    torch.backends.cudnn.deterministic = False
    try:
        losses, grads = [], []
        for i in range(rows["lb_idx"].shape[0]):
            losses.append(ref.step(data, {k: v[i] for k, v in rows.items()}))
            grads.append(ref.grads)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    return check.trajectory(losses, init, grads, leaves(ref))


def leaves(ref):
    """The reference's state by the program's leaf names."""
    out = {f"student.{k}": v for k, v in ref.student.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in ref.teacher.state_dict().items()})
    out.update({f"queue.{k}": v for k, v in ref.queue.items()})
    lq = dict(ref.lq)
    lq["valid"] = torch.tensor(bool(lq["valid"]))
    out.update({f"lq.{k}": v for k, v in lq.items()})
    out["choice_th"] = ref.choice_th
    return out
