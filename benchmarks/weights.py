"""Random weights of a configuration, made on the device from the seed.

One uniform and one normal draw cover every parameter of a model, in the
order of `named_parameters()`, which the leaves then scale by the rule
the model's family gives each (`init_rules` of
`reference/families/<family>.py`). BatchNorm keeps weight 1, bias 0,
running mean 0 and variance 1. Leaves are named as upstream's state_dict,
which the program's models and the plain reference share.
"""

import torch
from torch import nn

from benchmarks import registry


def _rules(model, family):
    """Each parameter's ('uniform', bound) | ('normal', std) |
    ('const', value), in the order of `named_parameters()`."""
    bn = {f"{n}.{k}" for n, m in model.named_modules()
          if isinstance(m, nn.BatchNorm2d) for k in ("weight", "bias")}
    own = registry.family(family).init_rules(model)
    rules = {}
    for name, _ in model.named_parameters():
        if name in bn:
            rules[name] = ("const", 1.0 if name.endswith("weight") else 0.0)
        elif name in own:
            rules[name] = own[name]
        else:
            raise ValueError(f"family {family!r} gives {name} no init rule")
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
