"""Random weights of a configuration, made on the device from the seed.

One uniform and one normal draw cover every parameter of a model, which
the leaves then scale: for the U-Net torch's default convolution init,
U(-b, b) with b = 1/sqrt(fan_in) (weights and biases); for DeepLabV2
kaiming-normal fan-out convolutions in the backbone and N(0, 0.01) heads
with zero biases. BatchNorm keeps weight 1, bias 0, running mean 0 and
variance 1. Leaves are named as upstream's state_dict, which the
program's models and the plain reference share.
"""

import math

import torch
from torch import nn


def _fan_in(w):
    return w.shape[1] * w[0, 0].numel()


def _rules(model, family):
    """Each parameter's ('uniform', bound) | ('normal', std) |
    ('const', value)."""
    bn = {f"{n}.{k}" for n, m in model.named_modules()
          if isinstance(m, nn.BatchNorm2d) for k in ("weight", "bias")}
    params = dict(model.named_parameters())
    rules = {}
    for name, p in params.items():
        if name in bn:
            rules[name] = ("const", 1.0 if name.endswith("weight") else 0.0)
        elif family == "unet":
            w = params[name.rsplit(".", 1)[0] + ".weight"]
            rules[name] = ("uniform", 1.0 / math.sqrt(_fan_in(w)))
        elif family == "deeplabv2" and name.startswith("classifier."):
            rules[name] = ("normal", 0.01) if name.endswith("weight") \
                else ("const", 0.0)
        elif family == "deeplabv2":
            rules[name] = ("normal", math.sqrt(2.0 / (p.shape[0]
                                                       * p[0, 0].numel())))
        else:
            raise ValueError(f"unknown model family {family!r}")
    return rules


def make_state_dicts(model, family, generator, count=2):
    """`count` independent state_dicts for `model` (the plain reference
    model of the configuration, on any device, the meta device too),
    drawn on the generator's device in a fixed order."""
    dev = generator.device
    params = dict(model.named_parameters())
    rules = _rules(model, family)
    n_u = sum(params[n].numel() for n, r in rules.items() if r[0] == "uniform")
    n_n = sum(params[n].numel() for n, r in rules.items() if r[0] == "normal")
    out = []
    for _ in range(count):
        u = torch.rand(n_u, generator=generator, device=dev) * 2.0 - 1.0
        z = torch.randn(n_n, generator=generator, device=dev)
        sd, iu, iz = {}, 0, 0
        for name, (kind, v) in rules.items():
            shape, k = params[name].shape, params[name].numel()
            if kind == "uniform":
                sd[name] = (u[iu:iu + k] * v).view(shape)
                iu += k
            elif kind == "normal":
                sd[name] = (z[iz:iz + k] * v).view(shape)
                iz += k
            else:
                sd[name] = torch.full(shape, v, device=dev)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                sd[name] = torch.zeros(buf.shape, device=dev)
            elif name.endswith("running_var"):
                sd[name] = torch.ones(buf.shape, device=dev)
            else:
                sd[name] = torch.zeros((), dtype=buf.dtype, device=dev)
        out.append(sd)
    return out
