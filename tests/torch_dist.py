"""Helpers of the mesh tests (tests/test_torch_parallel*.py and
tests/test_torch_spatial*.py):
ranks spawned with torch.multiprocessing, one thread each, over a Gloo
group whose rendezvous is a FileStore in the test's temporary directory
(no TCP port, so parallel test workers cannot collide), and the functions
the ranks run. Each rank saves what its function returns with torch.save;
`run_ranks` returns the list, rank by rank. The module imports no JAX, so
the spawned ranks start with torch and the port alone."""

import dataclasses
import os
import shutil
import time
from contextlib import contextmanager

import numpy as np
import torch
import torch.multiprocessing as mp

from ust_run_tpu_torch.models import UNet, Unet2D
from ust_run_tpu_torch.parallel import init_distributed, sync_batchnorm
from ust_run_tpu_torch.semisup import state as pstate
from ust_run_tpu_torch.semisup import step as pstep

TIMEOUT_S = 300


def _entry(rank, world, store, out_dir, fn, args, spatial):
    torch.set_num_threads(1)
    mesh = init_distributed(backend="gloo", device="cpu",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world, spatial=spatial)
    try:
        torch.save(fn(mesh, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.close()


def run_ranks(tmp_path, world, fn, *args, timeout=TIMEOUT_S, spatial=1):
    """fn(mesh, *args) on `world` spawned ranks, laid out as a
    (world // spatial) x spatial mesh; returns their results. A rank that
    raises fails the call with its traceback; ranks still running after
    `timeout` seconds are killed and the call fails."""
    out = tmp_path / f"{fn.__name__}_w{world}_{time.monotonic_ns()}"
    out.mkdir()
    ctx = mp.start_processes(_entry, args=(world, str(out / "store"),
                                           str(out), fn, args, spatial),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks took "
                                   f"more than {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(world)]
    shutil.rmtree(out)          # a rank's state runs to hundreds of MB
    return res


@contextmanager
def one_thread():
    """The single-process reference at the ranks' thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the train step on a seeded feed


def hyperparams(dataset, patch, lq_loss=False):
    """The port's HyperParams of tests/test_train_step.py:tiny_hp, batch
    2+2, for fundus (3 channels, multilabel) or BUSI (1 channel)."""
    fundus = dataset == "fundus"
    return pstep.HyperParams(
        dataset=dataset, patch=patch, channels=3 if fundus else 1,
        num_classes=2, multilabel=fundus, n_part=2 if fundus else 1,
        label_bs=2, unlabel_bs=2, queue_len=4, domain_num=2,
        threshold=0.95, cutmix_prob=1.0, LB=0.01, increase=1.0005,
        consistency=1.0, consistency_rampup=200.0, max_iterations=100,
        ema_decay=0.99, base_lr=0.03, min_v=0.5 if fundus else 0.1,
        max_v=1.5 if fundus else 2.0, fillcolor=255 if fundus else 0,
        blur_radius=3, lq_loss=lq_loss)


def corpus(hp, seed, n=6):
    """A uint8 corpus of n labelled and n unlabelled images, from a
    seed."""
    r = np.random.RandomState(seed)
    s, c = hp.patch, hp.channels
    vals = [0, 128, 255] if hp.dataset == "fundus" else [0, 255]
    data = {"lb_img": r.randint(0, 256, (n, s, s, c)),
            "lb_lab": r.choice(vals, (n, s, s, 1)),
            "ulb_img": r.randint(0, 256, (n, s, s, c)),
            "ulb_lab": r.choice(vals, (n, s, s, 1))}
    data = {k: torch.from_numpy(v.astype(np.uint8)) for k, v in data.items()}
    data["ulb_dc"] = torch.from_numpy(np.asarray([1, 2] * (n // 2),
                                                 np.int32))
    return data


def train_state(hp, seed, epoch, choice_th, model="unet"):
    """The port's train state: two UNets (or, with model "unet2d",
    Unet2Ds; "deeplabv2_r50", DeepLabV2s on ResNet-50) drawn from `seed`,
    at `epoch`, with `choice_th`."""
    from ust_run_tpu_torch.models import DeepLabV2
    make = {"unet": lambda: UNet(hp.channels, hp.num_classes),
            "unet2d": lambda: Unet2D(c=hp.channels,
                                     num_classes=hp.num_classes),
            "deeplabv2_r50": lambda: DeepLabV2("resnet50", hp.num_classes,
                                               hp.channels)}[model]
    nets = [make().init_weights_(torch.Generator().manual_seed(seed + i))
            for i in range(2)]
    st = pstate.create_train_state(hp, seed, "cpu", *nets)
    st.epoch = epoch
    st.choice_th = torch.tensor(choice_th, dtype=torch.float32)
    return st


def state_tensors(st):
    """Everything a rank must hold equal: both models' state_dicts, the
    SGD momentum, the queue, the LQ carry and choice_th, by name."""
    out = {f"student.{k}": v for k, v in st.student.state_dict().items()}
    out.update({f"teacher.{k}": v for k, v in st.teacher.state_dict().items()})
    out.update({f"momentum.{i}": s["momentum_buffer"] for i, s in
                st.optimizer.state_dict()["state"].items()})
    out.update({f"queue.{k}": v for k, v in st.queue.fields().items()})
    out.update({f"lq.{f.name}": getattr(st.lq, f.name)
                for f in dataclasses.fields(st.lq)})
    out["choice_th"] = st.choice_th
    return {k: v.detach().clone() for k, v in out.items()}


def norm_errs(got, want):
    """||got[k] - want[k]|| over ||want[k]||, by name, or over 1e-1 of the
    largest norm where that is more: a conv bias that a BatchNorm follows
    has a gradient of zero but for rounding."""
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    floor = 1e-1 * max(norms.values())
    return {k: float((got[k].double() - want[k].double()).norm())
            / max(norms[k], floor) for k in want}


FEED = [{"lb_idx": [0, 3], "ulb_idx": [1, 4]},
        {"lb_idx": [2, 5], "ulb_idx": [0, 3]}]


def run_steps(mesh, hp, seed, epoch, choice_th, model="unet"):
    """Two train steps on the seeded feed. Returns each step's packed
    metrics, the replicas' largest difference after the steps
    (mesh.max_replica_difference; 0 without a mesh) and, from rank 0
    alone, the gradient of the first step (the SGD momentum after it) and
    the state after both."""
    st = train_state(hp, seed, epoch, choice_th, model)
    if mesh is not None:
        for model in (st.student, st.teacher):
            sync_batchnorm(model, mesh)
    data = corpus(hp, seed)
    out = {"metrics": []}
    for i, idx in enumerate(FEED):
        idx = {k: torch.tensor(v) for k, v in idx.items()}
        out["metrics"].append(pstep.step_fn(st, data, idx, hp, mesh).numpy())
        if i == 0:
            first = {f"momentum.{j}": s["momentum_buffer"].clone() for j, s in
                     st.optimizer.state_dict()["state"].items()}
    state = state_tensors(st)
    out["replica_diff"] = 0.0 if mesh is None \
        else mesh.max_replica_difference(list(state.values()))
    if mesh is None or mesh.rank == 0:
        out.update(first_grad=first, state=state)
    return out


def run_steps_local_losses(mesh, hp, seed, epoch, choice_th):
    """run_steps with the loss that averaging the ranks' own losses (plain
    DDP) gives: each rank's loss terms of its rows alone, over the ranks,
    so that the gradient sum is the mean of the local gradients."""
    from ust_run_tpu_torch.utils import losses
    port, world = losses.ce_plus_dice, mesh.world

    def local_mean(*args, mesh=None, rows=None, **kw):
        return port(*args, **kw) / world
    losses.ce_plus_dice = local_mean
    try:
        return run_steps(mesh, hp, seed, epoch, choice_th)
    finally:
        losses.ce_plus_dice = port


def state_payload(st):
    """A train state's tensors and counters, to rebuild it in a rank."""
    return dict(student=st.student.state_dict(),
                teacher=st.teacher.state_dict(), step=st.step,
                epoch=st.epoch, queue=st.queue.fields(),
                lq=dataclasses.asdict(st.lq), choice_th=st.choice_th)


def run_fed_step(mesh, hp, payload, tea_in, inp, model="unet"):
    """One step from a given state (`state_payload`) and given inputs: the
    teacher's 3-group forward on `tea_in` (its BN fold), the student's
    loss, backward and `apply_update`, the inputs being `build_inputs`'
    dict from elsewhere; the models UNets or, with model "unet2d",
    Unet2Ds. Returns the replicas' largest difference (0 without a mesh)
    and, from rank 0 alone, the loss and its terms, the global gradient
    by parameter name and the state after the step."""
    make = (lambda: UNet(hp.channels, hp.num_classes)) if model == "unet" \
        else (lambda: zoo_model(model, hp.channels, hp.num_classes))
    st = pstate.create_train_state(hp, 0, "cpu", make(), make())
    st.student.load_state_dict(payload["student"])
    st.teacher.load_state_dict(payload["teacher"])
    st.step, st.epoch = payload["step"], payload["epoch"]
    # copies: the step writes the state in place, and the ranks (threads)
    # share `payload`
    st.queue = pstate.CurriculumQueue(**{k: v.clone() for k, v in
                                         payload["queue"].items()})
    st.lq = pstate.LQCarry(**{k: v.clone() for k, v in
                              payload["lq"].items()})
    st.choice_th = payload["choice_th"].clone()
    if mesh is not None:
        for model in (st.student, st.teacher):
            sync_batchnorm(model, mesh)
    pstep.teacher_forward(st.teacher, tea_in, mesh)
    st.optimizer.zero_grad()
    loss, aux = pstep.loss_terms(st, inp, hp, mesh)
    loss.backward()
    inp = dict(inp, feed=pstep.unpack_feed(torch.from_numpy(
        pstep.pack_feed(hp, st.step, st.epoch)), hp))
    pstep.apply_update(st, inp, loss, aux, hp, mesh)   # sums the grads
    state = state_tensors(st)
    out = dict(replica_diff=0.0 if mesh is None else
               mesh.max_replica_difference(list(state.values())))
    if mesh is None or mesh.rank == 0:
        out.update(loss=loss.detach(), state=state,
                   terms={k: aux[k].detach() for k in
                          ("sup_loss", "unsup_ul", "unsup_lu", "unsup_s")},
                   grads={n: p.grad.clone()
                          for n, p in st.student.named_parameters()})
    return out


# ---------------------------------------------------------------------------
# the evaluator


def _evaluator(mesh, dataset, root, size, domains, batch):
    from ust_run_tpu_torch.config import TrainConfig
    from ust_run_tpu_torch.data.datasets import SegmentationDataset
    from ust_run_tpu_torch.data.pipeline import TestLoader
    from ust_run_tpu_torch.engine.evaluator import Evaluator

    cfg = TrainConfig(dataset=dataset, patch_override=size,
                      data_root=root).resolve()
    p = cfg.profile()
    return Evaluator(pstep.HyperParams.from_config(cfg), [
        TestLoader(SegmentationDataset(dataset, p, root, "test", -1, [d]),
                   batch) for d in domains], list(p.parts), "cpu", mesh)


def centred_unet(dataset, root, size, domains, seed):
    """A UNet state_dict drawn from `seed` whose out conv's biases are
    shifted by each class's mean logit over the test images, so that the
    predicted masks are neither empty nor full."""
    ev = _evaluator(None, dataset, root, size, domains, 8)
    net = UNet(ev.hp.channels, ev.hp.num_classes).init_weights_(
        torch.Generator().manual_seed(seed))
    net.eval()
    from ust_run_tpu_torch.ops import augment
    with torch.no_grad():
        logits = torch.cat([net(augment.normalize(
            torch.from_numpy(b["image"]).float())) for ld in ev.loaders
            for b in ld])
        net.outc.conv.bias -= logits.mean(dim=(0, 1, 2))
    return net.state_dict()


def run_eval(mesh, dataset, root, size, domains, batch, state_dict):
    """The port's Evaluator over `domains` of the synthetic corpus at
    `root` (patch `size`, padded batches of `batch`), a UNet with
    `state_dict`, on `mesh` (None: one process). Returns what `evaluate`
    returns, and how many samples this rank evaluated."""
    ev = _evaluator(mesh, dataset, root, size, domains, batch)
    net = UNet(ev.hp.channels, ev.hp.num_classes)
    net.load_state_dict(state_dict)
    res = ev.evaluate(net, 1)
    res["n_local"] = sum(len(ev.local(ld).rows) for ld in ev.loaders)
    return res


# ---------------------------------------------------------------------------
# GroupedBatchNorm alone


def bn_inputs(sizes, c=8, hw=6, seed=0, height=None):
    """(x, r): an NCHW input of the groups `sizes` (hw x hw, or height x
    hw) and a random projection for the loss sum(y * r)."""
    g = torch.Generator().manual_seed(seed)
    n = sum(sizes)
    shape = (n, c, height or hw, hw)
    x = torch.randn(shape, generator=g) * 1.5 + 0.3
    r = torch.randn(shape, generator=g)
    return x, r


def run_bn(mesh, sizes, valid, seed=0, height=None, relu=False):
    """GroupedBatchNorm (weight U(0.5,1.5), bias N(0,0.1)) in train mode on
    this rank's slice of each group (on a space axis, its row slab of
    each image, `height` rows high), the ReLU fused if `relu`, then the
    loss sum(y * r) of the slice backward: (y, dL/dx of the slice,
    dL/dweight, dL/dbias shares, running statistics)."""
    from ust_run_tpu_torch.models.layers import GroupedBatchNorm
    x, r = bn_inputs(sizes, seed=seed, height=height)
    bn = GroupedBatchNorm(x.shape[1])
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.1, generator=g)
    local = sizes
    if mesh is not None:
        sync_batchnorm(bn, mesh)
        nhwc = [t.permute(0, 2, 3, 1) for t in (x, r)]
        (x, local), (r, _) = (mesh.shard(t, sizes) for t in nhwc)
        x, r = x.permute(0, 3, 1, 2), r.permute(0, 3, 1, 2)
    x.requires_grad_()
    y = bn(x, group_sizes=local, group_valid=torch.tensor(valid), relu=relu)
    gx, gw, gb = torch.autograd.grad((y * r).sum(), [x, bn.weight, bn.bias])
    return dict(y=y.detach(), gx=gx, gw=gw, gb=gb,
                running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone(),
                tracked=bn.num_batches_tracked.clone())


# ---------------------------------------------------------------------------
# the gradient convention


def convention_inputs(n=6, d=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, d), generator=g)


def convention_losses(x, mesh=None, n_fold=False):
    """Two losses of the global batch from this rank's rows `x`:
      * replicated consumer: P = [sum x^2, sum x] over all rows, L1 =
        P0 / (1 + P1^2), every rank computing L1 from P;
      * sharded consumer (the BN pattern): m = sum x / n over all rows,
        L2 = sum over all rows of (x * m)^2, each rank summing its own.
    `n_fold` gives the replicated consumer an all-reduce in its backward
    as well (the N-fold error) for contrast."""
    part = torch.stack([torch.sum(x * x), torch.sum(x)])
    stat = torch.stack([torch.sum(x), torch.tensor(float(x.shape[0]))])
    if mesh is not None:
        part = mesh.sum_sharded(part) if n_fold else mesh.sum_replicated(part)
        stat = mesh.sum_sharded(stat)
    l1 = part[0] / (1.0 + part[1] ** 2)
    m = stat[0] / stat[1]
    return l1, torch.sum((x * m) ** 2)


def run_convention(mesh, n_fold):
    """This rank's rows of `convention_inputs` -> (L1, its gradient, the
    gradient of this rank's L2 share)."""
    x, _ = mesh.shard(convention_inputs(), (6,))
    x.requires_grad_()
    l1, l2 = convention_losses(x, mesh, n_fold)
    g1, = torch.autograd.grad(l1, x)
    g2, = torch.autograd.grad(l2, x)
    return dict(l1=l1.detach(), g1=g1, g2=g2)


def dice_inputs(seed=0):
    """Fundus-like logits (4,8,8,2), targets (dense in the first two
    images, sparse in the last two, so the halves' dice losses differ)
    and a confidence mask."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((4, 8, 8, 2), generator=g) * 2
    cut = torch.tensor([0.3, 0.3, 0.97, 0.97])[:, None, None, None]
    target = (torch.rand((4, 8, 8, 2), generator=g) > cut).float()
    mask = (torch.rand((4, 8, 8, 2), generator=g) > 0.2).float()
    return logits, target, mask


def run_ce_dice(mesh):
    """ce_plus_dice of this rank's rows under the mesh (the global
    batch's loss) and, for contrast, of the rows alone; each with its
    gradient."""
    from ust_run_tpu_torch.utils import losses as L
    out = {}
    for name, m in (("global", mesh), ("local", None)):
        logits, target, mask = (mesh.shard(t, (4,))[0]
                                for t in dice_inputs())
        logits.requires_grad_()
        loss = L.ce_plus_dice(logits, target, multilabel=True, n_classes=2,
                              mask=mask, mesh=m, rows=4)
        out[name] = (loss.detach(), torch.autograd.grad(loss, logits)[0])
    return out


# ---------------------------------------------------------------------------
# the train entry under environment variables


def entry_argv(tmp_path):
    """The train entry's flags on a tiny synthetic fundus corpus: patch 32,
    one test domain, epochs of one step, on the CPU."""
    from ust_run_tpu_torch.data import synthetic
    root = synthetic.generate("fundus", str(tmp_path / "fundus"), n_train=5,
                              n_test=1, size=32, seed=0)
    return ["--dataset", "fundus", "--data_root", root, "--lb_num", "3",
            "--num_eval_iter", "1", "--patch_override", "32",
            "--eval_batch", "2", "--domain_num", "1", "--model_root",
            str(tmp_path / "model"), "--device", "cpu", "--overwrite"]


def run_train_entry(mesh, argv, env):
    """The train entry on `mesh` with `env` set: {"step", "exit"} (the
    exit code of a SystemExit, else None)."""
    from ust_run_tpu_torch import train
    from ust_run_tpu_torch.config import build_parser
    os.environ.update(env)
    try:
        trainer = train.run(build_parser().parse_args(argv), train.__file__,
                            mesh)
    except SystemExit as e:
        return {"step": None, "exit": e.code}
    return {"step": trainer.state.step, "exit": None}


# ---------------------------------------------------------------------------
# planted faults of the space axis (parallel/spatial.py)


def tanh_in_bn(forward):
    """GroupedBatchNorm's `forward` with the ReLU that a caller fuses into
    the layer (relu=True) a tanh: the smooth models of the space-axis
    tests."""
    def bn_then_tanh(self, x, *args, relu=False, **kw):
        y = forward(self, x, *args, **kw)
        return torch.tanh(y) if relu else y
    return bn_then_tanh


@contextmanager
def planted_slab(fault):
    """A fault of the zoo's slab operations in place in this process for
    the block, each of which must miss the bars of the tests it is
    planted in: "aspp_zero" (DeepLab's shared 24-row ASPP halo zeroed,
    as if every slab were the image), "local_resize" (the x8 resize by
    F.interpolate(align_corners=True) on the slab, i.e. on the slab's
    corners), "upsample_zeros" (zeros past the image's edges in
    upsample2x's halo instead of the edge row), "pool_zeros" (zeros
    instead of -inf in the max pool's), "zero_halo" (every halo zeroed),
    or None; and "smooth", no fault: every F.relu, and every ReLU fused
    into a GroupedBatchNorm (relu=True), a tanh, so that no kink can flip
    (a model built inside the block keeps it)."""
    import torch.nn.functional as F
    from ust_run_tpu_torch.models.layers import GroupedBatchNorm
    from ust_run_tpu_torch.parallel import spatial
    saved = [(spatial, "halo_rows", spatial.halo_rows),
             (spatial, "resize_align_corners",
              spatial.resize_align_corners), (F, "relu", F.relu),
             (GroupedBatchNorm, "forward", GroupedBatchNorm.forward)]
    halo = spatial.halo_rows
    bn_forward = GroupedBatchNorm.forward

    def zeroed(x, mesh, top=1, bottom=1, fill="zeros", bounds=None):
        return F.pad(x, (0, 0, top, bottom))

    def refilled(old, new):
        def fn(x, mesh, top=1, bottom=1, fill="zeros", bounds=None):
            return halo(x, mesh, top, bottom, new if fill == old else fill,
                        bounds)
        return fn

    if fault == "aspp_zero":
        spatial.halo_rows = lambda x, mesh, top=1, bottom=1, fill="zeros", \
            bounds=None: (zeroed if top == 24 else halo)(x, mesh, top,
                                                         bottom, fill, bounds)
    elif fault == "local_resize":
        spatial.resize_align_corners = lambda x, h2, w2, mesh, sizes: \
            F.interpolate(x, size=(h2, w2), mode="bilinear",
                          align_corners=True)
    elif fault == "upsample_zeros":
        spatial.halo_rows = refilled("edge", "zeros")
    elif fault == "pool_zeros":
        spatial.halo_rows = refilled("neg_inf", "zeros")
    elif fault == "zero_halo":
        spatial.halo_rows = zeroed
    elif fault == "smooth":
        F.relu = torch.tanh

        GroupedBatchNorm.forward = tanh_in_bn(bn_forward)
    try:
        yield
    finally:
        for obj, name, v in saved:
            setattr(obj, name, v)


def gather_layer(mesh, local, sizes):
    """A model's NCHW activations at any layer, this rank's (samples x
    rows) share of the groups `sizes` (mesh.shard's GroupSizes) -> every
    sample's whole layer on every rank: a sum all-reduce of a zero
    buffer holding each rank's share at its place (rows by
    spatial.layout)."""
    import torch.distributed as dist
    from ust_run_tpu_torch.parallel import spatial
    from ust_run_tpu_torch.parallel.mesh import shard_slice
    n, c, h, w = local.shape
    a, b = spatial.layout(mesh, sizes, w, h)[mesh.space_index]
    height = spatial.layout(mesh, sizes, w)[-1][1]
    out = local.new_zeros((sum(sizes.total), c, height, w))
    start = pos = 0
    for total in sizes.total:
        sl = shard_slice(total, mesh.data_index, mesh.data)
        k = sl.stop - sl.start
        out[start + sl.start:start + sl.stop, :, a:b] = local[pos:pos + k]
        start, pos = start + total, pos + k
    dist.all_reduce(out, group=mesh.group)
    return out


def shard_layer(mesh, full, sizes):
    """The inverse of `gather_layer`: this rank's (samples x rows) share
    of a whole layer `full` (NCHW)."""
    from ust_run_tpu_torch.parallel import spatial
    from ust_run_tpu_torch.parallel.mesh import shard_slice
    a, b = spatial.layout(mesh, sizes, full.shape[3])[mesh.space_index]
    parts, start = [], 0
    for total in sizes.total:
        sl = shard_slice(total, mesh.data_index, mesh.data)
        parts.append(full[start + sl.start:start + sl.stop, :, a:b])
        start += total
    return torch.cat(parts)


def zoo_model(kind, channels=3, classes=2):
    """A zoo model of the space-axis tests: "resnet" (ResNet at depth
    (1, 1, 1, 1): one block a stage keeps every stride and dilation),
    "r50" (DeepLabV2 on ResNet-50) or "unet2d"."""
    from ust_run_tpu_torch.models import DeepLabV2, ResNet
    if kind == "resnet":
        return ResNet((1, 1, 1, 1), channels)
    if kind == "r50":
        return DeepLabV2("resnet50", classes, channels)
    return Unet2D(c=channels, num_classes=classes)


def run_zoo_model(mesh, kind, sd, x, r, groups, fault=None):
    """A zoo model (`zoo_model`) with state_dict `sd` in train mode on
    this rank's share of NHWC `x` in `groups` BN groups (without a mesh,
    on all of it), the loss sum(y * r) backward, with `fault` of
    `planted_slab` in place. y is the logits (NHWC) or, for the ResNet,
    c4 (NCHW, `r` shaped alike). Returns y gathered, the gradients
    summed over the ranks, the running statistics and the replicas'
    largest difference."""
    from ust_run_tpu_torch.parallel import bind_mesh
    sizes = (x.shape[0] // groups,) * groups
    kw = dict(groups=groups)
    if mesh is not None:
        x, kw["group_sizes"] = mesh.shard(x, sizes)
        r = shard_layer(mesh, r, kw["group_sizes"]) if kind == "resnet" \
            else mesh.shard(r, sizes)[0]
    with planted_slab(fault):
        net = zoo_model(kind, x.shape[-1])
        net.load_state_dict(sd)
        net.train()
        if mesh is not None:
            bind_mesh(net, mesh)
        y = net(x.permute(0, 3, 1, 2), **kw)[-1] if kind == "resnet" \
            else net(x, **kw)
        (y * r).sum().backward()
    y = y.detach()
    out = dict(replica_diff=0.0)
    if mesh is not None:
        mesh.all_reduce_grads(net.parameters())
        y = gather_layer(mesh, y, kw["group_sizes"]) if kind == "resnet" \
            else mesh.gather(y, sizes, kw["group_sizes"].height)
        state = list(net.state_dict().values()) \
            + [p.grad for p in net.parameters()]
        out["replica_diff"] = mesh.max_replica_difference(state)
    out.update(y=y, grads={n: p.grad for n, p in net.named_parameters()},
               state={k: v for k, v in net.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))})
    return out


def run_zoo_models(mesh, runs):
    """run_zoo_model for each (kind, sd, x, r, groups, fault) of `runs` in
    one spawn of the ranks; rank 0 returns the results, the others their
    replica differences."""
    res = []
    for run in runs:
        out = run_zoo_model(mesh, *run)
        res.append(out if mesh.rank == 0 else
                   {"replica_diff": out["replica_diff"]})
    return res


def run_steps_smooth(mesh, *args):
    """run_steps with every F.relu a tanh (planted_slab's "smooth")."""
    with planted_slab("smooth"):
        return run_steps(mesh, *args)
