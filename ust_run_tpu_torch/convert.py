"""Weight bridge: the JAX package's variables -> the port's state_dicts.

Inverts the layout maps of ust_run_tpu/utils/torch_import.py:
  * conv kernels: flax (kh, kw, in, out) -> torch (out, in, kh, kw);
  * transpose conv: flax (kh, kw, in, out), spatially flipped ->
    torch (in, out, kh, kw);
  * dense kernels: flax (in, out) -> torch (out, in);
  * GroupedBatchNorm scale/bias/mean/var -> weight/bias/running_mean/
    running_var (num_batches_tracked 0); GroupNorm scale/bias ->
    weight/bias; DSBN's stacked (d, C) arrays -> `bns.{d}.*`.
One function per model family: the UNet (the JAX tree is the same
whatever `pack_l1` / `split_up` were, since the packed and split modules
create the unpacked parameters), the dilated ResNet, DeepLabV2, the
Unet2D family (Unet2D, _MT, _DS, _MS, Encoder, Decoder, RecDecoder,
Discriminator, any norm) and WideResNet. Leaves may be numpy or any
array-like.
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))   # a fresh copy


def _conv(kernel):
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _convT(kernel):
    return _t(np.transpose(np.asarray(kernel)[::-1, ::-1], (2, 3, 0, 1)))


def _conv_into(sd, prefix, p):
    sd[f"{prefix}weight"] = _conv(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}bias"] = _t(p["bias"])


def _bn_into(sd, prefix, p, s):
    sd[f"{prefix}weight"] = _t(p["scale"])
    sd[f"{prefix}bias"] = _t(p["bias"])
    sd[f"{prefix}running_mean"] = _t(s["mean"])
    sd[f"{prefix}running_var"] = _t(s["var"])
    sd[f"{prefix}num_batches_tracked"] = torch.tensor(0)


def _double_conv(sd, prefix, params, stats):
    for j, (conv, bn) in enumerate(((0, 1), (3, 4))):
        sd[f"{prefix}.{conv}.weight"] = _conv(params[f"Conv_{j}"]["kernel"])
        _bn_into(sd, f"{prefix}.{bn}.", params[f"GroupedBatchNorm_{j}"],
                 stats[f"GroupedBatchNorm_{j}"])


def unet_state_dict_from_jax(variables):
    """{'params', 'batch_stats'} of ust_run_tpu.models.UNet ->
    state_dict for ust_run_tpu_torch.models.UNet."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    _double_conv(sd, "inc.double_conv", params["inc"], stats["inc"])
    for i in range(1, 5):
        _double_conv(sd, f"down{i}.maxpool_conv.1.double_conv",
                     params[f"down{i}"]["DoubleConv_0"],
                     stats[f"down{i}"]["DoubleConv_0"])
    for i in range(1, 5):
        _double_conv(sd, f"up{i}.conv.double_conv",
                     params[f"up{i}"]["DoubleConv_0"],
                     stats[f"up{i}"]["DoubleConv_0"])
        ct = params[f"up{i}"]["ConvTranspose_0"]
        sd[f"up{i}.up.weight"] = _convT(ct["kernel"])
        sd[f"up{i}.up.bias"] = _t(ct["bias"])
    sd["outc.conv.weight"] = _conv(params["outc"]["kernel"])
    sd["outc.conv.bias"] = _t(params["outc"]["bias"])
    return sd


def resnet_state_dict_from_jax(variables, prefix=""):
    """ust_run_tpu.models.resnet.ResNet variables (any layer counts) ->
    state_dict for ust_run_tpu_torch.models.resnet.ResNet (torchvision's
    keys, `layer{s}_{i}` -> `layer{s}.{i}`, `ds_conv`/`ds_bn` ->
    `downsample.0/1`), each key under `prefix`."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    _conv_into(sd, f"{prefix}conv1.", params["conv1"])
    _bn_into(sd, f"{prefix}bn1.", params["bn1"], stats["bn1"])
    for name, p in params.items():
        if not name.startswith("layer"):
            continue
        stage, i = name[len("layer"):].split("_")
        s = stats[name]
        t = f"{prefix}layer{stage}.{i}."
        for j in (1, 2, 3):
            _conv_into(sd, f"{t}conv{j}.", p[f"conv{j}"])
            _bn_into(sd, f"{t}bn{j}.", p[f"bn{j}"], s[f"bn{j}"])
        if "ds_conv" in p:
            _conv_into(sd, f"{t}downsample.0.", p["ds_conv"])
            _bn_into(sd, f"{t}downsample.1.", p["ds_bn"], s["ds_bn"])
    return sd


def deeplab_state_dict_from_jax(variables):
    """ust_run_tpu.models.DeepLabV2 variables -> state_dict for
    ust_run_tpu_torch.models.DeepLabV2 (`backbone.*`, `classifier.{0..3}`
    for the ASPP rates 6/12/18/24)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = resnet_state_dict_from_jax(
        {"params": params["backbone_net"],
         "batch_stats": stats["backbone_net"]}, "backbone.")
    for idx, d in enumerate((6, 12, 18, 24)):
        _conv_into(sd, f"classifier.{idx}.", params[f"aspp_{d}"])
    return sd


def _norm_into(sd, prefix, p, s):
    """A JAX `Norm` (unet2d.py:37-61) -> the port's normalisation layer.
    norm='in' has no variables and no entry."""
    if "GroupedBatchNorm_0" in p:
        _bn_into(sd, prefix, p["GroupedBatchNorm_0"],
                 s["GroupedBatchNorm_0"])
    elif "GroupNorm_0" in p:
        sd[f"{prefix}weight"] = _t(p["GroupNorm_0"]["scale"])
        sd[f"{prefix}bias"] = _t(p["GroupNorm_0"]["bias"])
    else:
        q = p["DomainSpecificBatchNorm2d_0"]
        r = s["DomainSpecificBatchNorm2d_0"]
        for d in range(np.shape(q["scale"])[0]):
            _bn_into(sd, f"{prefix}bns.{d}.",
                     {"scale": q["scale"][d], "bias": q["bias"][d]},
                     {"mean": r["mean"][d], "var": r["var"][d]})


def unet2d_state_dict_from_jax(variables):
    """Variables of any model of ust_run_tpu/models/unet2d.py -> its
    port's state_dict: the `enc`/`dec` levels are flattened into
    upstream's `convd*`/`convu*` blocks (convJ + normJ), and top-level
    convolutions (seg*, rec1, out1, the Discriminator's c0..c4) keep
    their names."""
    stats = variables.get("batch_stats", {})
    mods = []
    for name, p in variables["params"].items():
        if name in ("enc", "dec"):
            mods += [(k, v, stats.get(name, {}).get(k, {}))
                     for k, v in p.items()]
        else:
            mods.append((name, p, stats.get(name, {})))
    sd = {}
    for name, p, s in mods:
        if "kernel" in p:                                   # a head
            _conv_into(sd, f"{name}.", p)
            continue
        for sub, q in p.items():                            # a block
            if sub.startswith("conv"):
                _conv_into(sd, f"{name}.{sub}.", q)
            else:
                _norm_into(sd, f"{name}.{sub}.", q, s.get(sub, {}))
    return sd


def wrn_state_dict_from_jax(variables):
    """ust_run_tpu.models.WideResNet variables -> state_dict for
    ust_run_tpu_torch.models.WideResNet (`block{b}_{i}` ->
    `block{b}.layer.{i}`)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    _conv_into(sd, "conv1.", params["conv1"])
    for name, p in params.items():
        if not name.startswith("block"):
            continue
        b, i = name[len("block"):].split("_")
        t = f"block{b}.layer.{i}."
        for sub, q in p.items():
            if sub.startswith("conv"):
                _conv_into(sd, f"{t}{sub}.", q)
            else:
                _bn_into(sd, f"{t}{sub}.", q, stats[name][sub])
    _bn_into(sd, "bn1.", params["bn1"], stats["bn1"])
    sd["fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
    sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd
