"""TransUNet R50-ViT-B/16 in the port (models/transunet.py): against the
plain reference family of the benchmark (benchmarks/reference/families/
transunet.py, float32 torch written from the paper) at a narrow size on
the CPU, its published size's parameters and keys, the zero-padded 1/4
skip, the SSL step through `build_model`, a short run of the trainer,
evaluation, its span on the stage clock, and the attention counters.

Tolerances, float32 on the CPU: the logits 1e-5 of their norm (the two
sides order their sums differently: GroupedBatchNorm's moments as
E[x^2] - E[x]^2 against torch's BatchNorm, the resize as two matrix
products against F.interpolate, the attention's softmax after a float32
product); each gradient leaf's gap over the larger of its norm and the
median leaf's, as benchmarks/check.py measures, 1e-2: the step's group
of one image is normalised over conv_more's 4 x 4 map, which amplifies
rounding through the backward (the worst leaf reads 4.6e-3 here, and at
128 px the reference itself reads 6.6e-3 from its own float64 run, the
port 1.6e-2), while three groups of two read 2.4e-5."""

import pytest
import torch

from torch_threads import single_thread  # noqa: F401
from torch_unroll import corpus, hp_for, index_rows
from ust_run_tpu_torch.config import TrainConfig
from ust_run_tpu_torch.models import transunet
from ust_run_tpu_torch.ops import attention
from ust_run_tpu_torch.semisup import state as pstate
from ust_run_tpu_torch.semisup import step as pstep
from ust_run_tpu_torch.utils import trace

pytestmark = pytest.mark.usefixtures("single_thread")

CPU = torch.device("cpu")
NARROW = dict(hidden=64, layers=2, heads=4, mlp=128, units=(1, 1, 1),
              width=32, head_channels=64, decoder=(32, 16, 16, 8), n_skip=3)
REF_NARROW = dict(hidden_size=64, num_layers=2, num_heads=4, head_size=16,
                  mlp_dim=128, resnet_units=[1, 1, 1], width=32,
                  head_channels=64, decoder_channels=[32, 16, 16, 8],
                  n_skip=3)


def _config(patch):
    from benchmarks import registry
    config = registry.config("transunet_prostate")
    config["patch"] = patch
    config["model"].update(REF_NARROW)
    return config


def _pair(patch=64, seed=3):
    """The port's and the reference's narrow TransUNet (1 channel, 2
    classes) holding the same random weights (the benchmark's rules, with
    every norm's weight and bias and the position embeddings drawn too)."""
    from benchmarks.reference import models
    ref = models.build(_config(patch))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    * (0.2 if p.ndim > 1 else 0.1)
                    + (1.0 if name.endswith(("gn1.weight", "gn2.weight",
                                             "gn3.weight", "norm.weight"))
                       else 0.0))
    port = transunet.TransUNet(1, 2, patch, **NARROW)
    port.load_state_dict(ref.state_dict())
    return port, ref


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@pytest.mark.parametrize("groups,sizes,valid", [
    (3, None, None),
    (1, (4, 4, 4, 4, 4, 1), (True,) * 5 + (False,))],
    ids=["groups3", "sizes6_lq_invalid"])
def test_port_matches_reference(groups, sizes, valid):
    """Logits and every parameter's gradient of the port's one grouped
    call equal the reference's one call a group (train-mode BatchNorm on
    each group alone); the running statistics fold the valid groups in
    order."""
    port, ref = _pair()
    sizes = sizes or (2,) * groups
    x = torch.randn(sum(sizes), 64, 64, 1, generator=torch.Generator()
                    .manual_seed(1))
    w = torch.randn(sum(sizes), 64, 64, 2, generator=torch.Generator()
                    .manual_seed(2))
    gv = None if valid is None else torch.tensor(valid)
    y = port(x, groups=groups if groups > 1 else 1,
             group_sizes=None if groups > 1 else sizes, group_valid=gv)
    parts, at = [], 0
    bns = [m for m in ref.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for i, n in enumerate(sizes):
        for bn in bns:        # an invalid group folds nothing
            bn.momentum = 0.0 if valid is not None and not valid[i] else 0.1
        parts.append(ref(x[at:at + n]))
        at += n
    y_ref = torch.cat(parts)
    assert _rel(y, y_ref) < 1e-5
    (y * w).sum().backward()
    (y_ref * w).sum().backward()
    ref_grads = {k: p.grad for k, p in ref.named_parameters()}
    median = float(torch.stack([g.norm() for g in ref_grads.values()])
                   .median())
    for name, p in port.named_parameters():
        g = ref_grads[name]
        # the key's bias has no gradient in exact arithmetic (a row's
        # softmax does not see the constant q . b_k it adds): held to the
        # median leaf's scale like every leaf
        gap = float((p.grad - g).norm()) / max(float(g.norm()), median)
        assert gap < 1e-2, (name, gap)
    ref_state = ref.state_dict()
    for name, t in port.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert _rel(t, ref_state[name]) < 1e-5, name


def test_published_size_parameters_and_keys():
    """R50-ViT-B/16 at 384: 105,567,906 parameters, the configuration's
    count, and the reference's state_dict keys and shapes in its order."""
    from benchmarks import registry
    from benchmarks.reference import models
    config = registry.config("transunet_prostate")
    with torch.device("meta"):
        port = transunet.TransUNet(1, 2, 384, **transunet.R50_VIT_B16)
        ref = models.build(config)
    n = sum(p.numel() for p in port.parameters())
    assert n == config["model"]["parameters"] == 105_567_906
    assert [(k, v.shape) for k, v in port.state_dict().items()] \
        == [(k, v.shape) for k, v in ref.state_dict().items()]
    assert port.transformer.embeddings.position_embeddings.shape \
        == (1, 576, 768)
    assert len(port.transformer.encoder.layer) == 12


def test_quarter_skip_is_zero_padded_at_384():
    """At 384 the max pool without padding gives 95 rows; stage 1's skip
    is zero-padded at the bottom and right to 96, as upstream pads it;
    the 1/8 skip and the root need none."""
    stem = transunet.ResNetV2((1, 1, 1), 32)
    with torch.no_grad():
        x, feats = stem(torch.randn(1, 3, 384, 384))
    assert [tuple(f.shape[1:]) for f in feats] == [(256, 48, 48),
                                                   (128, 96, 96),
                                                   (32, 192, 192)]
    assert tuple(x.shape[1:]) == (512, 24, 24)
    quarter = feats[1]
    assert torch.equal(quarter[:, :, 95, :], torch.zeros(1, 128, 96))
    assert torch.equal(quarter[:, :, :, 95], torch.zeros(1, 128, 96))
    assert bool(quarter[:, :, :95, :95].ne(0).any())


def test_amp_keeps_the_stem_in_float32():
    """With `amp` the hybrid stem's convolutions and GroupNorms run in
    float32 (bf16 operands there leave its GroupNorm gradients to
    rounding) and in NCHW memory in a channels_last model (torch's
    GroupNorm would copy channels_last to NCHW); the patch embedding, the
    encoder's linears and the decoder's convolutions run in bf16, the
    patch embedding and the decoder channels_last; the logits come out
    float32."""
    port = transunet.TransUNet(1, 2, 64, amp=True, **NARROW).to(
        memory_format=torch.channels_last)
    seen = {}

    def keep(name):
        def hook(mod, args, out):
            fmt = (torch.channels_last if name in ("patch", "decoder")
                   else torch.contiguous_format)
            seen[name] = (out.dtype, out.is_contiguous(memory_format=fmt))
        return hook

    hm = port.transformer.embeddings.hybrid_model
    named = {"root.conv": hm.root.conv, "root.gn": hm.root.gn,
             "block3.conv3": hm.body.block3.unit1.conv3,
             "patch": port.transformer.embeddings.patch_embeddings,
             "query": port.transformer.encoder.layer[0].attn.query,
             "decoder": port.decoder.blocks[2].conv1[0]}
    for name, mod in named.items():
        mod.register_forward_hook(keep(name))
    y = port(torch.randn(2, 64, 64, 1))
    assert y.dtype == torch.float32
    f32, bf16 = torch.float32, torch.bfloat16
    assert seen == {"root.conv": (f32, True), "root.gn": (f32, True),
                    "block3.conv3": (f32, True), "patch": (bf16, True),
                    "query": (bf16, True), "decoder": (bf16, True)}


def _state(hp, seed, monkeypatch):
    monkeypatch.setattr(transunet, "R50_VIT_B16", NARROW)
    cfg = TrainConfig(dataset="prostate", model="transunet")
    init = torch.Generator().manual_seed(seed)
    models = [pstate.build_model(cfg, hp, init) for _ in range(2)]
    assert all(isinstance(m, transunet.TransUNet) for m in models)
    st = pstate.create_train_state(hp, seed, "cpu", *models)
    st.choice_th.fill_(2.0)
    return st


def _two_steps(hp, seed, monkeypatch):
    st = _state(hp, seed, monkeypatch)
    data = corpus(hp, seed)
    metrics = [pstep.step_fn(st, data, r, hp)
               for r in index_rows(seed, 2, hp)]
    return st, torch.stack(metrics)


def test_step_through_build_model(monkeypatch):
    """`--model transunet` through build_model and two `step_fn` steps at
    32 px: finite losses, a teacher that moves under the EMA, and the same
    bits from one seed twice; the clock counts `model.vit` twice a step
    (the teacher's call and the student's) and the attention calls are
    the layers' of both calls."""
    hp = hp_for("prostate")
    trace.reset()
    pstep.reset_counts()
    st, m = _two_steps(hp, 0, monkeypatch)
    assert torch.isfinite(m[:, 0]).all()
    before = _state(hp, 0, monkeypatch).teacher.state_dict()
    moved = [k for k, v in st.teacher.state_dict().items()
             if not torch.equal(v, before[k])]
    assert "transformer.encoder.layer.0.attn.query.weight" in moved
    clock = trace.stage_totals(CPU, "eager", trace.STAGES
                               + trace.MODEL_SPANS)
    assert clock["model.vit"][0] == 4 and clock["step.update"][0] == 2
    assert clock["model.vit"][1] > 0
    assert attention.launches == 2 * 2 * NARROW["layers"]
    st2, m2 = _two_steps(hp, 0, monkeypatch)
    assert torch.equal(m, m2)
    for k, v in st.student.state_dict().items():
        assert torch.equal(v, st2.student.state_dict()[k]), k
    for k, v in st.teacher.state_dict().items():
        assert torch.equal(v, st2.teacher.state_dict()[k]), k


def test_multi_step_counts(monkeypatch):
    """The CPU K-step call: `model.vit` twice a step on the eager path, 2
    x layers attention calls a step, none captured."""
    hp = hp_for("prostate")
    st = _state(hp, 1, monkeypatch)
    data = corpus(hp, 1)
    rows = index_rows(1, 3, hp)
    idxs = {n: torch.stack([r[n] for r in rows]) for n in rows[0]}
    feeds = pstep.host_to_device(pstep.draw_feeds(st, hp, 3), "cpu")
    trace.reset()
    pstep.reset_counts()
    captured = attention.captured
    pstep.multi_step(st, data, idxs, feeds, hp)
    clock = trace.stage_totals(CPU, "eager", trace.STAGES
                               + trace.MODEL_SPANS)
    assert clock["model.vit"][0] == 6
    assert attention.launches == 3 * 2 * NARROW["layers"]
    assert attention.captured == captured


def test_trainer_runs_transunet(tmp_path, monkeypatch):
    """`--model transunet` through the trainer's normal path on the CPU
    (narrow, 32 px): two steps, the evaluation, and the epoch's stage
    line with `model.vit` after the five step stages."""
    from ust_run_tpu_torch import train
    from ust_run_tpu_torch.data.synthetic import generate

    monkeypatch.setattr(transunet, "R50_VIT_B16", NARROW)
    root = generate("fundus", str(tmp_path / "fundus"), n_train=5,
                    n_test=1, size=32, seed=0)
    train.main(["--dataset", "fundus", "--data_root", root, "--lb_domain",
                "1", "--lb_num", "3", "--num_eval_iter", "2",
                "--max_iterations", "2", "--patch_override", "32",
                "--eval_batch", "2", "--model", "transunet", "--model_root",
                str(tmp_path / "model"), "--save_name", "t", "--device",
                "cpu"])
    log = open(tmp_path / "model" / "fundus" / "t" / "log.txt").read()
    lines = log.splitlines()
    at = next(i for i, ln in enumerate(lines) if "epoch 1:" in ln)
    values = lines[at + 1].split("eager x2: ")[1].split(", ")
    assert [v.split()[0] for v in values] == [
        s.split(".")[1] for s in trace.STAGES + trace.MODEL_SPANS]
    assert all(float(v.split()[1]) > 0 for v in values)
    assert any("domain1 epoch" in ln for ln in lines), log[-2000:]


def test_eval_forward(monkeypatch):
    """In eval mode the model normalises by its running statistics: an
    image's logits do not depend on the batch around it, and a forward
    outside a step leaves the stage clock alone."""
    port, _ = _pair(patch=32)
    port.eval()
    x = torch.randn(3, 32, 32, 1, generator=torch.Generator().manual_seed(4))
    trace.reset()
    with torch.no_grad():
        y = port(x)
        y0 = port(x[:1])
    assert y.shape == (3, 32, 32, 2) and y.dtype == torch.float32
    assert torch.allclose(y[:1], y0, rtol=1e-5, atol=1e-6)
    clock = trace.stage_totals(CPU, "eager", trace.MODEL_SPANS)
    assert clock["model.vit"] == (0, 0.0)


def test_mesh_raises():
    """A TransUNet bound to a mesh (data axis) raises at its forward."""
    from types import SimpleNamespace
    from ust_run_tpu_torch import parallel
    port, _ = _pair(patch=32)
    parallel.bind_mesh(port, SimpleNamespace(space=1))
    with pytest.raises(ValueError, match="one device"):
        port(torch.zeros(2, 32, 32, 1))


def test_init_weights():
    """Upstream's init from a CPU generator: xavier-uniform MLP weights,
    N(0, 1e-6) MLP biases, zero position embeddings, norms at 1 and 0,
    torch's default bound elsewhere; the same generator seed draws the
    same weights."""
    def build():
        return transunet.TransUNet(1, 2, 64, **NARROW).init_weights_(
            torch.Generator().manual_seed(9))

    m = build()
    fc1 = m.transformer.encoder.layer[0].ffn.fc1
    top = float(fc1.weight.detach().abs().max())
    assert 0.9 * (6 / (64 + 128)) ** 0.5 < top <= (6 / (64 + 128)) ** 0.5
    assert float(fc1.bias.detach().abs().max()) < 1e-5
    q = m.transformer.encoder.layer[0].attn.query
    assert float(q.weight.detach().abs().max()) <= 64 ** -0.5
    assert not bool(m.transformer.embeddings.position_embeddings.any())
    gn = m.transformer.embeddings.hybrid_model.root.gn
    assert torch.equal(gn.weight, torch.ones(32))
    other = build().state_dict()
    assert all(torch.equal(v, other[k]) for k, v in m.state_dict().items())


@pytest.mark.cuda
def test_flash_backward_is_bit_stable_on_card():
    """On a card, with --deterministic 1's flag: flash attention's
    backward gives the same bits run to run, and the deterministic flags
    it switches on for its node are restored after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (flash attention has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(4, 12, 576, 64, device="cuda", generator=g,
                               dtype=torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [torch.autograd.grad(attention.attention(q, k, v), (q, k, v),
                                    do) for _ in range(4)]
    finally:
        torch.backends.cudnn.deterministic = flag
    assert all(torch.equal(a, b) for r in runs[1:]
               for a, b in zip(runs[0], r))
    assert not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(ValueError, match="bf16"):
        attention.attention(q.float(), k.float(), v.float())
