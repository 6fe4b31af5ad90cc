"""The plain float32 models, and the layers whose precision the control
lowers.

Each model family is a module `families/<family>.py` with `build(config)`,
the plain model of a configuration file's `model` block (NHWC float32 in
and out), and `init_rules(model)`, its parameters' init rules
(benchmarks/weights.py); `build` finds it by the `family` name, so a new
family is an added file. A family builds its convolutions and linear
layers from the classes here, so that the control reaches them:
`precision` selects how they round their operands, "fp32" (TF32 is
switched by the caller), or "fp8": input, weight and output quantised to
float8 e4m3 with one scale per tensor, and the output's gradient to
e5m2, as fp8 training does.
"""

import torch
import torch.nn.functional as F
from torch import nn

from benchmarks import registry


def _quantise(x, dtype, fmax):
    scale = fmax / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _quantise(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _quantise(grad, torch.float8_e5m2, 57344.0)


class Conv2d(nn.Conv2d):
    precision = "fp32"

    def forward(self, x):
        if self.precision != "fp8":
            return super().forward(x)
        y = self._conv_forward(_Fp8.apply(x), _Fp8.apply(self.weight),
                               self.bias)
        return _Fp8.apply(y)


class ConvTranspose2d(nn.ConvTranspose2d):
    precision = "fp32"

    def forward(self, x):
        if self.precision != "fp8":
            return super().forward(x)
        y = F.conv_transpose2d(_Fp8.apply(x), _Fp8.apply(self.weight),
                               self.bias, self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return _Fp8.apply(y)


class Linear(nn.Linear):
    precision = "fp32"

    def forward(self, x):
        if self.precision != "fp8":
            return super().forward(x)
        y = F.linear(_Fp8.apply(x), _Fp8.apply(self.weight), self.bias)
        return _Fp8.apply(y)


def set_precision(model, precision):
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.precision = precision
    return model


def build(config):
    """The plain float32 model of a configuration file's `model` block,
    built by its family's module (`families/<family>.py`)."""
    return registry.family(config["model"]["family"]).build(config)
