"""Weight bridge: the JAX package's UNet variables -> the port's state_dict.

Inverts the layout maps of ust_run_tpu/utils/torch_import.py:20-25:
  * conv kernels: flax (kh, kw, in, out) -> torch (out, in, kh, kw);
  * transpose conv: flax (kh, kw, in, out), spatially flipped ->
    torch (in, out, kh, kw);
  * GroupedBatchNorm scale/bias/mean/var -> weight/bias/running_mean/
    running_var.
The JAX tree is the same whatever `pack_l1` / `split_up` were (the packed
and split modules create the unpacked parameters).
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))   # a fresh copy


def _conv(kernel):
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _convT(kernel):
    return _t(np.transpose(np.asarray(kernel)[::-1, ::-1], (2, 3, 0, 1)))


def _double_conv(sd, prefix, params, stats):
    for j, (conv, bn) in enumerate(((0, 1), (3, 4))):
        sd[f"{prefix}.{conv}.weight"] = _conv(params[f"Conv_{j}"]["kernel"])
        p = params[f"GroupedBatchNorm_{j}"]
        s = stats[f"GroupedBatchNorm_{j}"]
        sd[f"{prefix}.{bn}.weight"] = _t(p["scale"])
        sd[f"{prefix}.{bn}.bias"] = _t(p["bias"])
        sd[f"{prefix}.{bn}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.{bn}.running_var"] = _t(s["var"])
        sd[f"{prefix}.{bn}.num_batches_tracked"] = torch.tensor(0)


def unet_state_dict_from_jax(variables):
    """{'params', 'batch_stats'} of ust_run_tpu.models.UNet (numpy or
    array-like leaves) -> state_dict for ust_run_tpu_torch.models.UNet."""
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
