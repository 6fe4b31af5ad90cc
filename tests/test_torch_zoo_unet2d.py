"""The port's Unet2D family, DomainSpecificBatchNorm2d and WideResNet
against the JAX package on the CPU, float32.

Inputs and weights are drawn with numpy from a seed; the JAX variables go
to the port through ust_run_tpu_torch.convert (its Unet2D-family map
covers every norm). Train-mode forwards run with 3 BN groups or with
unequal `group_sizes` whose last group is left out of the running-
statistic fold; outputs and updated running statistics are compared at
rtol/atol 1e-4, then eval mode with the updated statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (GROUPINGS, assert_close, assert_stats, init_fn,
                          jit_apply, loaded, nchw, nhwc, random_variables)
from torch_threads import single_thread  # noqa: F401
from ust_run_tpu.models import unet2d as junet2d
from ust_run_tpu.models.dsbn import DomainSpecificBatchNorm2d as JaxDSBN
from ust_run_tpu.models.wrn import build_WideResNet as jax_wrn
from ust_run_tpu_torch import convert
from ust_run_tpu_torch.models import (DomainSpecificBatchNorm2d,
                                      build_WideResNet, unet2d)

pytestmark = pytest.mark.usefixtures("single_thread")


def _unet2d_case(norm, grouping):
    """(JAX model, call kwargs for JAX / the port, port model) of Unet2D
    with `norm`."""
    nd = 3 if norm == "dsbn" else None
    model = junet2d.Unet2D(c=2, n=4, norm=norm, num_classes=3,
                           num_domains=nd)
    net = unet2d.Unet2D(c=2, n=4, norm=norm, num_classes=3, num_domains=nd)
    _, kw_j, kw_t = GROUPINGS[grouping]
    if norm == "dsbn":
        kw_j = dict(kw_j, domain_label=jnp.asarray([2, 0]))
        kw_t = dict(kw_t, domain_label=torch.tensor([2, 0]))
    return model, kw_j, kw_t, net


@pytest.mark.parametrize("norm,grouping", [
    ("bn", "groups3"), ("bn", "sizes"), ("gn", "groups3"), ("in", "sizes"),
    ("dsbn", "groups3")])
def test_unet2d_matches_jax(norm, grouping):
    n = GROUPINGS[grouping][0]
    x = np.random.RandomState(5).uniform(-1, 1, (n, 32, 32, 2)) \
        .astype(np.float32)
    model, kw_j, kw_t, net = _unet2d_case(norm, grouping)
    dl = {"domain_label": kw_j["domain_label"]} if norm == "dsbn" else {}
    v = random_variables(init_fn(model, x, train=False, **dl), 6)
    loaded(net, convert.unet2d_state_dict_from_jax(v))
    out_j, upd = jit_apply(model, v, x, train=True, mutable=["batch_stats"],
                        **kw_j)
    net.train()
    with torch.no_grad():
        out_t = net(torch.from_numpy(x), **kw_t)
    assert_close(out_t, out_j)
    upd_v = {"params": v["params"], **upd}
    if norm in ("bn", "dsbn"):
        assert_stats(net, convert.unet2d_state_dict_from_jax(upd_v))
    net.eval()
    dl_t = {"domain_label": kw_t["domain_label"]} if norm == "dsbn" else {}
    with torch.no_grad():
        out_e = net(torch.from_numpy(x), **dl_t)
    assert_close(out_e, jit_apply(model, upd_v, x, train=False, **dl))


def _variant(name):
    """(JAX model, port model, input shape, JAX call kwargs, port call
    kwargs) of a Unet2D-family module."""
    if name == "mt_seg":
        return (junet2d.Unet2D_MT(c=3, n=4), unet2d.Unet2D_MT(c=3, n=4),
                (2, 32, 32, 3), {}, {})
    if name == "mt_rec":
        return (junet2d.Unet2D_MT(c=3, n=4), unet2d.Unet2D_MT(c=3, n=4),
                (2, 32, 32, 3), dict(is_rec=True), dict(is_rec=True))
    if name == "ds":
        return (junet2d.Unet2D_DS(c=1, n=4), unet2d.Unet2D_DS(c=1, n=4),
                (2, 32, 32, 1), dict(deep_sup=True), dict(deep_sup=True))
    if name == "ms":
        return (junet2d.Unet2D_MS(c=1, n=4, norm="gn"),
                unet2d.Unet2D_MS(c=1, n=4, norm="gn"), (2, 32, 32, 1),
                dict(multi_scale_output=True),
                dict(multi_scale_output=True))
    if name == "encoder":
        return (junet2d.Encoder(c=1, n=4), unet2d.Encoder(c=1, n=4),
                (2, 32, 32, 1), {}, {})
    if name == "rec_decoder":
        return (junet2d.RecDecoder(n=4, num_classes=2, norm="dsbn",
                                   num_domains=2),
                unet2d.RecDecoder(n=4, num_classes=2, norm="dsbn",
                                  num_domains=2), (2, 2, 2, 64),
                dict(domain_label=jnp.asarray([1])),
                dict(domain_label=torch.tensor([1])))
    return (junet2d.Discriminator(input_nc=3, n=4),
            unet2d.Discriminator(input_nc=3, n=4), (2, 64, 64, 3), {}, {})


def _outs(o):
    return list(o) if isinstance(o, (list, tuple)) else [o]


@pytest.mark.parametrize("name", ["mt_seg", "mt_rec", "ds", "ms", "encoder",
                                  "rec_decoder", "discriminator"])
def test_unet2d_variants_match_jax(name):
    """Unet2D_MT (both heads), _DS and _MS (every head), Encoder,
    RecDecoder (DSBN) and Discriminator, train then eval mode; the
    Decoder runs on the Encoder's JAX features."""
    model, net, shape, kw_j, kw_t = _variant(name)
    x = np.random.RandomState(7).uniform(-1, 1, shape).astype(np.float32)
    disc = name == "discriminator"
    init_kw = {} if disc else dict(train=False, **kw_j)
    v = random_variables(init_fn(model, x, **init_kw), 8)
    loaded(net, convert.unet2d_state_dict_from_jax(v))
    for train in ((False,) if disc else (True, False)):
        net.train(train)
        if disc:
            want = jit_apply(model, v, x)
        else:       # eval mode reads the statistics the train call folded
            want, upd = jit_apply(model, v, x, train=train,
                               mutable=["batch_stats"], **kw_j)
            v = {"params": v["params"], **upd}
        with torch.no_grad():
            got = net(torch.from_numpy(x), **kw_t)
        for i, (a, b) in enumerate(zip(_outs(got), _outs(want))):
            assert tuple(a.shape) == b.shape
            assert_close(a, b, f"output {i}, train={train}")
    if name == "encoder":
        dec_j = junet2d.Decoder(n=4, num_classes=2)
        dec_t = unet2d.Decoder(n=4, num_classes=2)
        feats = [np.asarray(f) for f in want]
        dv = random_variables(
            lambda: dec_j.init(jax.random.PRNGKey(0), feats, train=False), 9)
        loaded(dec_t, convert.unet2d_state_dict_from_jax(dv)).eval()
        with torch.no_grad():
            got = dec_t([torch.from_numpy(f) for f in feats])
        assert_close(got, dec_j.apply(dv, feats, train=False))


def test_dsbn_matches_jax():
    """Two domains in turn through one layer: each train call normalises
    with the batch statistics and folds only its domain's running
    statistics; eval mode then reads each domain's own."""
    rng = np.random.RandomState(10)
    x = (rng.normal(size=(4, 6, 5, 3)) * 2 + 1).astype(np.float32)
    j = JaxDSBN(num_domains=2)
    v = random_variables(
        lambda: j.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.zeros((4,), jnp.int32), train=False), 11)
    t = DomainSpecificBatchNorm2d(3, 2)

    def to_port(variables):
        return convert.unet2d_state_dict_from_jax(
            {"params": {"m": {"bn1": {
                "DomainSpecificBatchNorm2d_0": variables["params"]}}},
             "batch_stats": {"m": {"bn1": {
                 "DomainSpecificBatchNorm2d_0":
                     variables["batch_stats"]}}}})

    def port_sd(sd):
        return {k[len("m.bn1."):]: w for k, w in sd.items()}

    t.load_state_dict(port_sd(to_port(v)))
    stats = v["batch_stats"]
    for d in (1, 0):
        label = np.full((4,), d, np.int32)
        want, upd = j.apply({"params": v["params"], "batch_stats": stats},
                            jnp.asarray(x), jnp.asarray(label), train=True,
                            mutable=["batch_stats"])
        stats = upd["batch_stats"]
        t.train()
        with torch.no_grad():
            got = t(nchw(x), torch.from_numpy(label))
        assert_close(nhwc(got), want, f"domain {d}")
        want_sd = port_sd(to_port({"params": v["params"],
                                   "batch_stats": stats}))
        for k, w in t.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert_close(w, want_sd[k].numpy(), k)
        assert int(t.bns[d].num_batches_tracked) == 1
    t.eval()
    for d in (0, 1):
        label = np.full((4,), d, np.int32)
        with torch.no_grad():
            got = t(nchw(x), torch.from_numpy(label))
        assert_close(nhwc(got), j.apply({"params": v["params"],
                                    "batch_stats": stats},
                                   jnp.asarray(x), jnp.asarray(label),
                                   train=False), f"eval domain {d}")


def test_wrn_matches_jax():
    """WideResNet-10-2 (bn_momentum 0.01, leaky slope 0.1): logits and
    pooled features in train mode with the running statistics, then eval
    mode."""
    args = dict(depth=10, widen_factor=2, bn_momentum=0.01, leaky_slope=0.1)
    model = jax_wrn(**args).build(num_classes=5, in_channel=3)
    net = build_WideResNet(**args).build(num_classes=5, in_channel=3)
    x = np.random.RandomState(12).uniform(-1, 1, (4, 32, 32, 3)) \
        .astype(np.float32)
    v = random_variables(init_fn(model, x, train=False), 13)
    loaded(net, convert.wrn_state_dict_from_jax(v))
    (logits_j, feat_j), upd = jit_apply(model, v, x, train=True, ood_test=True,
                                     mutable=["batch_stats"])
    net.train()
    with torch.no_grad():
        logits_t, feat_t = net(torch.from_numpy(x), ood_test=True)
    assert_close(logits_t, logits_j)
    assert_close(feat_t, feat_j)
    upd_v = {"params": v["params"], **upd}
    assert_stats(net, convert.wrn_state_dict_from_jax(upd_v))
    net.eval()
    with torch.no_grad():
        assert_close(net(torch.from_numpy(x)),
               jit_apply(model, upd_v, x, train=False))
