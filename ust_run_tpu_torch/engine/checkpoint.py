"""Checkpoints in upstream's `.pth` format (port of
ust_run_tpu/engine/checkpoint.py).

Reference (utils/util.py:259-297, train.py:542-548, 946-958):
  * the rolling `checkpoint.pth`, written after every epoch: a dict with
    `state_dict` (the student), `ema_state_dict` (the teacher) and
    `epoch`, as ust_run_tpu/utils/torch_import.py:230-256 reads it. The
    port adds what a bit-equal resume needs: the SGD state, `step`, the
    curriculum queue and LQ carry, `choice_th`, both generators' states,
    the samplers' states, and the best-dice bookkeeping (`best_dice`,
    `best_iter`, `stu_best_dice`, `stu_best_iter`);
  * `unet_avg_dice_best_model.pth`, a bare student `state_dict`, written
    on a new best student average dice and loaded by test.py:242.
    `load_best_model` also reads the JAX package's best model, a pickle
    of `{"params", "batch_stats"}` numpy trees (its checkpoint.py:90-93),
    through a restricted unpickler and the `convert` bridges; the JAX
    rolling `checkpoint.pth` pickles a JAX TrainState and is refused;
  * `--load` resumes from `<model_root>/<dataset>/<save_name>/
    checkpoint.pth` (the `--load_path` flag is dead upstream and here).

Every file holds only tensors, numbers, strings and containers of them,
so it loads with `torch.load(weights_only=True)`. Writes go to a temp
file, are fsynced and renamed into place; the state is copied to the host
before a worker thread writes it, so later steps cannot change it
mid-write.
"""

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import torch

from ust_run_tpu_torch import convert
from ust_run_tpu_torch.semisup.state import CurriculumQueue, LQCarry

# --model -> the bridge from the JAX package's variables
JAX_BRIDGES = {"unet": convert.unet_state_dict_from_jax,
               "unet2d": convert.unet2d_state_dict_from_jax,
               "unet2d_dsbn": convert.unet2d_state_dict_from_jax,
               "deeplabv2": convert.deeplab_state_dict_from_jax,
               "deeplabv2_r50": convert.deeplab_state_dict_from_jax}


def host_copy(obj):
    """A host copy of every tensor in a nest of dicts, lists and tuples
    (contiguous, detached, never aliasing the live state)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", memory_format=torch.contiguous_format,
                               copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


def atomic_save(path, payload):
    """torch.save to a sibling temp file, fsync, then os.replace(): a crash
    mid-write can never truncate the only resume artifact."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class AsyncCheckpointer:
    """Writes host copies on one worker thread while training goes on;
    `wait` re-raises a failed write."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._future = None

    def submit(self, fn, *args):
        self.wait()
        self._future = self._pool.submit(fn, *args)

    def wait(self):
        future, self._future = self._future, None
        if future is not None:
            future.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._pool.shutdown()


def state_payload(state, epoch, bests, samplers):
    """The rolling checkpoint's dict for `state` (on its device; pass it
    through `host_copy` before handing it to a writer). `bests` =
    (best_dice, best_iter, stu_best_dice, stu_best_iter); `samplers` maps
    a name to a sampler state."""
    best_dice, best_iter, stu_best_dice, stu_best_iter = bests
    return {
        "epoch": epoch,
        "state_dict": state.student.state_dict(),
        "ema_state_dict": state.teacher.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "queue": state.queue.fields(),
        "lq": {"img": state.lq.img, "pl": state.lq.pl, "conf": state.lq.conf,
               "valid": state.lq.valid},
        "choice_th": state.choice_th,
        "generator": state.generator.get_state(),
        "host_generator": state.host_generator.get_state(),
        "samplers": samplers,
        "best_dice": float(best_dice), "best_iter": int(best_iter),
        "stu_best_dice": float(stu_best_dice),
        "stu_best_iter": int(stu_best_iter),
    }


def load_checkpoint(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_best_model(path, model="unet"):
    """A student state_dict from a best-model file: the port's or
    upstream's torch file (a bare state_dict, or a full checkpoint's
    `state_dict`), or the JAX package's pickle, told apart by the first
    two bytes as the JAX loader does (checkpoint.py:119-136: "PK" is a
    torch zip file) and converted for `model` (a --model value)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"PK":
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in payload and isinstance(payload["state_dict"],
                                                  dict):
            return payload["state_dict"]
        return payload
    with open(path, "rb") as f:
        try:
            variables = _NumpyUnpickler(f).load()
        except pickle.UnpicklingError as e:
            raise ValueError(
                f"{path} is neither a torch file nor the JAX package's "
                f"best-model pickle ({e}); the JAX rolling checkpoint.pth "
                "holds a JAX TrainState, which the port cannot read: "
                "evaluate the run's <model>_avg_dice_best_model.pth") from e
    if not (isinstance(variables, dict) and set(variables) == {
            "params", "batch_stats"}):
        raise ValueError(f"{path}: not a JAX best model ({{'params', "
                         "'batch_stats'}} expected)")
    if model not in JAX_BRIDGES:
        raise ValueError(f"no JAX bridge for --model {model!r}")
    return JAX_BRIDGES[model](variables)


class _NumpyUnpickler(pickle.Unpickler):
    """Admits only numpy's array-rebuilding globals (numpy 1 and 2 names),
    so a pickle loads without running other code or importing jax/flax."""

    ALLOWED = {(m, n) for m in ("numpy.core.multiarray",
                                "numpy._core.multiarray")
               for n in ("_reconstruct", "scalar")} | {
        (m, "_frombuffer") for m in ("numpy.core.numeric",
                                     "numpy._core.numeric")} | {
        ("numpy", "ndarray"), ("numpy", "dtype")}

    def find_class(self, module, name):
        if (module, name) in self.ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"global {module}.{name} is not a "
                                     "numpy array's")


def _incompatible(what):
    return ValueError(
        "checkpoint is incompatible with the configured model: " + what
        + " (different --model, dataset profile or patch size)")


def _check_tensors(live, saved, where):
    if set(live) != set(saved):
        missing = sorted(set(live) - set(saved))[:3]
        extra = sorted(set(saved) - set(live))[:3]
        raise _incompatible(f"{where} keys differ (missing {missing}, "
                            f"unexpected {extra})")
    for k, v in live.items():
        if tuple(v.shape) != tuple(saved[k].shape):
            raise _incompatible(
                f"{where}[{k!r}] has shape {tuple(saved[k].shape)} where "
                f"the live state expects {tuple(v.shape)}")


def restore_onto(module, state_dict):
    """load_state_dict with a readable error when keys or shapes differ."""
    _check_tensors(module.state_dict(), state_dict, "state_dict")
    module.load_state_dict(state_dict)


def restore_state(state, payload):
    """Put a rolling checkpoint back into the live train state, in place.
    The state gets copies: training on never writes into `payload` (on
    the CPU, `.to` and the optimizer's `load_state_dict` would alias it),
    so a payload can be restored again."""
    restore_onto(state.student, payload["state_dict"])
    restore_onto(state.teacher, payload["ema_state_dict"])
    live_q = state.queue.fields()
    _check_tensors(live_q, payload["queue"], "queue")
    lq = payload["lq"]
    _check_tensors({"img": state.lq.img, "pl": state.lq.pl,
                    "conf": state.lq.conf}, {k: lq[k] for k in
                                             ("img", "pl", "conf")}, "lq")
    state.optimizer.load_state_dict(host_copy(payload["optimizer"]))
    dev = state.choice_th.device
    state.queue = CurriculumQueue(**{k: payload["queue"][k].to(dev, copy=True)
                                     for k in live_q})
    state.lq = LQCarry(**{k: lq[k].to(dev, copy=True) for k in
                          ("img", "pl", "conf", "valid")})
    state.choice_th = payload["choice_th"].to(dev, copy=True)
    state.generator.set_state(payload["generator"])
    state.host_generator.set_state(payload["host_generator"])
    state.step = int(payload["step"])
    return state
