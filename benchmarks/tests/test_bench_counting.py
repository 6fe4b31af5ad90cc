"""The operation and byte counts at the cells' shapes."""

import json

import pytest

from benchmarks import counting, registry


@pytest.mark.parametrize("name,gflop", [("unet_fundus", 96.34316288),
                                        ("deeplabv2_r101_fundus",
                                         88.925536256),
                                        ("unet_prostate", 216.432377856)])
def test_forward_flops_per_image(name, gflop):
    """2 FLOPs a multiply-add of every convolution, one image: UNet
    96.34 GFLOP and DeepLabV2-R101 (output stride 8) 88.93 at 3x256x256,
    UNet 216.43 at 1x384x384."""
    config = registry.config(name)
    got = counting.forward_flops_per_image(json.dumps(config))
    assert got / 1e9 == pytest.approx(gflop, rel=1e-9)
    assert config["flops"]["forward_gflop_per_image"] == pytest.approx(gflop)


@pytest.mark.parametrize("cell", ["unet_fundus.graph",
                                  "deeplabv2_r101_fundus.graph",
                                  "unet_prostate.graph"])
def test_step_flops(cell):
    """A step is the teacher's 12 forwards and the student's 21 forwards
    and backwards, less the first convolution's input gradient: just
    under 75 forward-equivalents, all of them in convolutions."""
    c = registry.cell(cell)
    config = registry.config(c["config"])
    fwd = counting.forward_flops_per_image(json.dumps(config))
    flops, conv_flops, conv_bytes = counting.step_counts(config, c)
    assert 74 * fwd < flops < 75 * fwd
    assert conv_flops == flops and conv_bytes > 0


def test_uniform_rng_bytes():
    """Two float32 fields of 256 x 256 for each of the 8 images."""
    c = registry.cell("unet_fundus.graph")
    assert counting.uniform_rng_bytes(registry.config(c["config"]), c) \
        == 16 * 256 * 256 * 4


def test_peaks_table():
    p = counting.peaks("NVIDIA H100 80GB HBM3")
    assert p["bfloat16"] == 989e12 and p["float32"] == 67e12
    assert counting.peaks("cpu") is None
