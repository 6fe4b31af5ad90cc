"""Operations and bytes of a cell's step, counted on the plain reference
model at the cell's shapes on the meta device (nothing is computed), and
the table of the card's peaks.

FLOPs are torch.utils.flop_counter's (2 per multiply-add: convolutions,
transposed convolutions included, and matrix products where a family has
them), counted in all and for the convolutions alone, over what a step
runs: the teacher's forward of its 3 x unlabel_bs images, and the
student's forward and backward of its 4 x unlabel_bs + label_bs + 1
images (the LQ image included, as the program's one batched call
computes it). The backward computes no gradient for the input images,
so the first convolution's input gradient is not counted. Bytes count
each convolution's inputs and outputs once (forward and both gradients),
in the cell's compute dtype.
"""

import functools
import json
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from benchmarks.reference import models

HERE = os.path.dirname(os.path.abspath(__file__))
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
_CONV_OPS = {"convolution", "convolution_backward"}


def peaks(kind):
    """The card's published peaks ({'bfloat16': FLOP/s, 'float32': ...,
    'hbm_bytes_per_s': ...}) by `torch.cuda.get_device_name()`, or None
    for a card the table does not hold."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)["cards"].get(kind)


class _ConvBytes(TorchDispatchMode):
    """Bytes that convolutions read and write, counted in elements."""

    def __init__(self):
        super().__init__()
        self.elements = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket.__name__ in _CONV_OPS:
            flat = list(args) + [out] if torch.is_tensor(out) \
                else list(args) + list(out)
            self.elements += sum(t.numel() for t in flat
                                 if torch.is_tensor(t))
        return out


def _count(config, images, backward):
    """(FLOPs, convolution FLOPs, convolution elements moved) of one call
    on `images` images."""
    with torch.device("meta"):
        model = models.build(config)
        x = torch.empty((images, config["patch"], config["patch"],
                         config["channels"]))
    model.train()
    flops, conv = FlopCounterMode(display=False), _ConvBytes()
    with flops, conv:
        y = model(x)
        if backward:
            y.sum().backward()
    by_op = flops.get_flop_counts()["Global"]
    conv_flops = sum(v for op, v in by_op.items()
                     if op.__name__ in _CONV_OPS)
    return flops.get_total_flops(), conv_flops, conv.elements


@functools.lru_cache(maxsize=None)
def forward_flops_per_image(config_json):
    return _count(json.loads(config_json), 1, False)[0]


@functools.lru_cache(maxsize=None)
def _step_counts(config_json, label_bs, unlabel_bs):
    config = json.loads(config_json)
    teacher = _count(config, 3 * unlabel_bs, False)
    student = _count(config, 4 * unlabel_bs + label_bs + 1, True)
    flops, conv_flops, conv_el = (t + s for t, s in zip(teacher, student))
    return flops, conv_flops, conv_el * DTYPE_BYTES[config["compute_dtype"]]


def step_counts(config, cell):
    """(FLOPs, convolution FLOPs, convolution bytes) of one step of the
    cell."""
    return _step_counts(json.dumps(config, sort_keys=True), cell["label_bs"],
                        cell["unlabel_bs"])


def uniform_rng_bytes(config, cell):
    """Bytes one launch of the uniform-field kernel writes: two float32
    fields of patch x patch for each image of the weak augmentation."""
    n = cell["label_bs"] + cell["unlabel_bs"]
    return 2 * n * config["patch"] ** 2 * 4
