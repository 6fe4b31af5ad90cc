"""The TransUNet configuration and cell, and the first queued cell
`unet_fundus.graph_b8`: FLOP counts at the cells' shapes, the family's
weights at a narrow size, the reference against the port's step at a
tiny size, and the attention count of `attention_roofline`."""

import hashlib
import json

import pytest
import torch

from benchmarks import attention, check, counting, harness, registry, weights
from benchmarks.reference import models
from conftest import tiny

# a narrow TransUNet: the reference's `model` block and the port's sizes
NARROW = dict(hidden_size=64, num_layers=2, num_heads=4, head_size=16,
              mlp_dim=128, resnet_units=[1, 1, 1], width=32,
              head_channels=64, decoder_channels=[32, 16, 16, 8], n_skip=3)
PORT_NARROW = dict(hidden=64, layers=2, heads=4, mlp=128, units=(1, 1, 1),
                   width=32, head_channels=64, decoder=(32, 16, 16, 8),
                   n_skip=3)


def test_forward_flops_per_image():
    """TransUNet R50-ViT-B/16 at 1x384x384: 179.61 GFLOP an image, 2 a
    multiply-add: the hybrid stem 23.02, the patch embedding 0.91, the
    encoder 110.08 (linears 97.85, attention's two products 12.23) and the
    decoder with its head 45.61."""
    config = registry.config("transunet_prostate")
    got = counting.forward_flops_per_image(json.dumps(config))
    assert got / 1e9 == pytest.approx(179.613696, rel=1e-9)
    assert config["flops"]["forward_gflop_per_image"] == pytest.approx(
        got / 1e9)
    layers, heads, n, d = attention.shape(config)
    assert (layers, heads, n, d) == (12, 12, 576, 64)
    assert config["model"]["hidden_size"] == heads * d


@pytest.mark.parametrize("cell,images", [("transunet_prostate.graph", 21),
                                         ("unet_fundus.graph_b8", 41)])
def test_step_flops(cell, images):
    """A step is the teacher's forwards and the student's forwards and
    backwards, less the first convolution's input gradient: just under
    75 forward-equivalents at batch 4+4 (12 + 3 x 21), just under 147 at
    8+8 (24 + 3 x 41). The UNet's are all convolutions; TransUNet's
    linears and attention products count in all but not in the
    convolutions'."""
    c = registry.cell(cell)
    config = registry.config(c["config"])
    teacher = 3 * c["unlabel_bs"]
    assert 4 * c["unlabel_bs"] + c["label_bs"] + 1 == images
    fwd = counting.forward_flops_per_image(json.dumps(config))
    flops, conv_flops, conv_bytes = counting.step_counts(config, c)
    assert (teacher + 3 * images - 1) * fwd < flops \
        < (teacher + 3 * images) * fwd
    assert conv_bytes > 0
    if config["model"]["family"] == "unet":
        assert conv_flops == flops
    else:
        assert 0.3 * flops < conv_flops < 0.45 * flops


def test_attention_counts_by_hand():
    """576 tokens of 64 in 12 heads and 12 layers, 12 teacher images and
    21 student images: 4 n^2 d an image and head forward, 2.5 times that
    backward; bytes Q, K, V, O and the float32 row statistics forward,
    dO, dQ, dK and dV backward, bf16."""
    config = registry.config("transunet_prostate")
    cell = registry.cell("transunet_prostate.graph")
    flops, nbytes = attention.step_counts(config, cell)
    fwd = 4 * 576 ** 2 * 64 * 144
    assert flops == fwd * 12 + fwd * 3.5 * 21
    t = 4 * 576 * 64 * 2 + 576 * 4
    assert nbytes == 144 * (12 * t + 21 * (t + 4 * 576 * 64 * 2))
    assert flops / 989e12 > nbytes / 3.35e12      # bound by the products


def _narrow_config():
    config = registry.config("transunet_prostate")
    config["model"].update(NARROW)
    return config


def _digest(sds):
    h = hashlib.sha256()
    for sd in sds:
        for k, v in sd.items():
            h.update(k.encode())
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def test_family_weights_at_a_narrow_size():
    """Both state_dicts of seed 2**31 + 17 on the CPU, narrow, hash to the
    recorded digest; each rule holds on its leaves; the published size's
    parameters and keys on the meta device are the configuration's and
    the port's."""
    config = _narrow_config()
    config["patch"] = 64
    with torch.device("meta"):
        structure = models.build(config)
    sds = weights.make_state_dicts(structure, "transunet",
                                   torch.Generator().manual_seed(2 ** 31 + 17))
    sd = sds[0]
    assert torch.equal(sd["transformer.embeddings.position_embeddings"],
                       torch.zeros(1, 16, 64))
    ln = "transformer.encoder.layer.0.attention_norm"
    assert torch.equal(sd[f"{ln}.weight"], torch.ones(64))
    assert float(sd["transformer.encoder.layer.0.ffn.fc1.bias"].std()) < 1e-5
    assert float(sd["transformer.encoder.layer.0.ffn.fc1.weight"].abs()
                 .max()) <= (6 / (64 + 128)) ** 0.5
    assert _digest(sds) == "56407437d818ff7c"

    from ust_run_tpu_torch.models import transunet
    full = registry.config("transunet_prostate")
    with torch.device("meta"):
        ref = models.build(full)
        port = transunet.TransUNet(1, 2, 384, **transunet.R50_VIT_B16)
    n = sum(p.numel() for p in ref.parameters())
    assert n == sum(p.numel() for p in port.parameters()) \
        == full["model"]["parameters"]
    assert [(k, v.shape) for k, v in ref.state_dict().items()] \
        == [(k, v.shape) for k, v in port.state_dict().items()]


def test_reference_agrees_with_step_fn(monkeypatch):
    """The narrow TransUNet at 32 px (4 tokens), float32 on the CPU: the
    port's K-step call and the plain reference agree on the losses to
    1e-5 and on every leaf's gradient of both steps and the state after
    them to 1e-2 (the softmax path's argmax flips, as for the prostate
    UNet in test_bench_reference.py)."""
    from ust_run_tpu_torch.models import transunet
    monkeypatch.setattr(transunet, "R50_VIT_B16", PORT_NARROW)
    cell, config = tiny("transunet_prostate.graph")
    config["model"].update(NARROW)
    cell["checked_steps"] = 2
    started = harness.Started(config, cell, 2 ** 31 + 3, torch.device("cpu"))
    started.free()
    ref = harness.reference(config, cell, 2 ** 31 + 3, started.data,
                            started.first)
    r = check.compare(started.trajectory, ref)
    assert r["loss_gap"] < 1e-5, r
    assert r["grad_gap"] < 1e-2, r
    assert r["grad_gap_step2"] < 1e-2, r
    assert r["change_gap"] < 1e-2, r
