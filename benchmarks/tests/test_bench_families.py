"""Model families as added files: a family module is found by its name,
the kept families draw the weights they drew before they moved into
modules of their own, and the control's layers round in float8."""

import hashlib
import json

import pytest
import torch
import torch.nn.functional as F

from benchmarks import counting, registry, weights
from benchmarks.reference import models

TOY = '''
import torch
from torch import nn

from benchmarks.reference.models import Conv2d, Linear


class Toy(nn.Module):
    def __init__(self, cin, width, classes):
        super().__init__()
        self.conv = Conv2d(cin, width, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(width)
        self.head = Linear(width, classes)

    def forward(self, x):
        y = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        return self.head(y.permute(0, 2, 3, 1))


def build(config):
    return Toy(config["channels"], config["model"]["width"],
               config["num_classes"])


def init_rules(model):
    return {"conv.weight": ("normal", 0.1), "head.weight": ("uniform", 0.5),
            "head.bias": ("const", 0.25)}
'''


def test_new_family_is_an_added_file(tmp_path, monkeypatch):
    """A family written to a families/ directory of its own is built,
    given weights, FLOP-counted and switched to float8 by name, with no
    file of the benchmark edited."""
    (tmp_path / "toy.py").write_text(TOY)
    monkeypatch.setattr(registry, "FAMILIES", str(tmp_path))
    config = {"model": {"family": "toy", "width": 8}, "channels": 3,
              "num_classes": 2, "patch": 16}
    with torch.device("meta"):
        structure = models.build(config)
    sds = weights.make_state_dicts(structure, "toy",
                                   torch.Generator().manual_seed(5))
    net = models.build(config)
    net.load_state_dict(sds[0])
    sd = sds[0]
    assert torch.equal(sd["bn.weight"], torch.ones(8))
    assert torch.equal(sd["head.bias"], torch.full((2,), 0.25))
    assert sd["head.weight"].abs().max() <= 0.5
    assert 0.05 < float(sd["conv.weight"].std()) < 0.2
    assert not torch.equal(sds[0]["conv.weight"], sds[1]["conv.weight"])
    assert net(torch.zeros(2, 16, 16, 3)).shape == (2, 16, 16, 2)
    # 2 FLOPs a multiply-add: the 3x3 convolution and the linear head
    conv, head = 2 * 16 * 16 * 8 * 3 * 9, 2 * 16 * 16 * 8 * 2
    assert counting.forward_flops_per_image(json.dumps(config)) \
        == conv + head
    models.set_precision(net, "fp8")
    assert net.conv.precision == net.head.precision == "fp8"
    with pytest.raises(ValueError, match="unknown model family"):
        registry.family("unet")


def _digest(sds):
    h = hashlib.sha256()
    for sd in sds:
        for k, v in sd.items():
            h.update(k.encode())
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name,narrow,digest", [
    ("unet_fundus", {"widths": [4, 8, 16, 32, 64]}, "b68a444c1ff22adb"),
    ("deeplabv2_r101_fundus", {"resnet_layers": [1, 1, 1, 1]},
     "a3290b35027ffcc4")])
def test_kept_families_draw_the_same_weights(name, narrow, digest):
    """Both state_dicts of seed 2**31 + 17 on the CPU, at a narrow size,
    hash to what the code drew before each family moved into a module of
    its own (families/<family>.py): the draw order and the rules are
    unchanged, so every earlier reading stands."""
    config = registry.config(name)
    config["model"].update(narrow)
    with torch.device("meta"):
        structure = models.build(config)
    sds = weights.make_state_dicts(structure, config["model"]["family"],
                                   torch.Generator().manual_seed(2 ** 31 + 17))
    assert _digest(sds) == digest


def _q(x):
    return models._quantise(x, torch.float8_e4m3fn, 448.0)


@pytest.mark.parametrize("make,shape,plain", [
    (lambda: models.Conv2d(4, 6, 3, padding=1), (2, 4, 8, 8),
     lambda x, m: F.conv2d(x, _q(m.weight), m.bias, padding=1)),
    (lambda: models.ConvTranspose2d(4, 6, 2, stride=2), (2, 4, 8, 8),
     lambda x, m: F.conv_transpose2d(x, _q(m.weight), m.bias, stride=2)),
    (lambda: models.Linear(4, 6), (2, 8, 4),
     lambda x, m: F.linear(x, _q(m.weight), m.bias))],
    ids=["Conv2d", "ConvTranspose2d", "Linear"])
def test_fp8_control_rounds(make, shape, plain):
    """The control's layers: float32 as torch's own layer, and under
    `set_precision(..., "fp8")` input, weight and output rounded to e4m3
    and the gradients to e5m2, so the control departs from float32."""
    torch.manual_seed(0)
    m = make()
    x = torch.randn(shape, requires_grad=True)
    y32 = m(x)
    (g32,) = torch.autograd.grad(y32.square().sum(), x)
    assert torch.equal(y32, type(m).__mro__[1].forward(m, x))
    models.set_precision(torch.nn.Sequential(m), "fp8")
    assert m.precision == "fp8"
    y8 = m(x)
    (g8,) = torch.autograd.grad(y8.square().sum(), x)
    assert torch.equal(y8, _q(plain(_q(x), m)))
    with torch.no_grad():
        rel = float((y8 - y32).norm() / y32.norm())
        grel = float((g8 - g32).norm() / g32.norm())
    assert 1e-3 < rel < 0.2 and 1e-3 < grel < 0.3, (rel, grel)
