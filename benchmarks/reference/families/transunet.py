"""The TransUNet family: TransUNet with the R50-ViT hybrid encoder
(Chen et al., arXiv:2102.04306) from a configuration's `model` block,
and its weights' init rule.

Written from the paper and upstream's code (github.com/Beckschen/
TransUNet: networks/vit_seg_modeling.py, vit_seg_modeling_resnet_skip.py,
vit_seg_configs.py:get_r50_b16_config), with upstream's state_dict keys:

  * a 1-channel image repeated to 3 channels;
  * ResNetV2: weight-standardised convolutions (per output channel,
    biased variance, eps 1e-5), root 7x7/2 + GroupNorm(32, eps 1e-6) +
    ReLU, max pool 3x3/2 without padding, pre-activation bottleneck units
    (`resnet_units`) at 4, 8 and 16 times `width`, stride 2 on the 3x3
    of each later stage's first unit, projection 1x1 + GroupNorm(cout,
    cout) where the stride or width changes; skips: stage 2, stage 1
    zero-padded at the bottom and right to in_size / 4, the root;
  * a 1x1 patch embedding with bias on the 1/16 grid, position
    embeddings, `num_layers` pre-LN blocks (LayerNorm eps 1e-6; attention
    softmax(Q K^T / sqrt(d)) V of `num_heads` heads, query, key, value
    and out linears with bias; MLP with exact GELU), `encoder_norm`;
  * the decoder: conv_more 3x3 (`hidden_size` -> `head_channels`) +
    BatchNorm + ReLU; blocks of a bilinear x2 upsample
    (F.interpolate, align_corners=True), the skip concatenated after it,
    two 3x3 Conv-BN-ReLU; the head a 3x3 convolution with bias.

Dropout is 0 (the configuration's `dropout_rate`). BatchNorm is
torch.nn.BatchNorm2d, per group as the step calls the model; GroupNorm
and LayerNorm are torch's. Convolutions and linear layers are the
precision-switchable classes of benchmarks/reference/models.py, the
standardised weight going through the same float8 rounding as a plain
convolution's. Inputs and logits are NHWC.
"""

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from benchmarks.reference.models import Conv2d, Linear, _Fp8


class StdConv2d(Conv2d):
    def forward(self, x):
        v, m = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True,
                              correction=0)
        w = (self.weight - m) / torch.sqrt(v + 1e-5)
        if self.precision != "fp8":
            return self._conv_forward(x, w, self.bias)
        return _Fp8.apply(self._conv_forward(_Fp8.apply(x), _Fp8.apply(w),
                                             self.bias))


class PreActBottleneck(nn.Module):
    def __init__(self, cin, cout, cmid, stride=1):
        super().__init__()
        self.gn1 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv1 = StdConv2d(cin, cmid, 1, bias=False)
        self.gn2 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride=stride, padding=1,
                               bias=False)
        self.gn3 = nn.GroupNorm(32, cout, eps=1e-6)
        self.conv3 = StdConv2d(cmid, cout, 1, bias=False)
        self.project = stride != 1 or cin != cout
        if self.project:
            self.downsample = StdConv2d(cin, cout, 1, stride=stride,
                                        bias=False)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x):
        residual = self.gn_proj(self.downsample(x)) if self.project else x
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return F.relu(residual + y)


class ResNetV2(nn.Module):
    def __init__(self, units, width):
        super().__init__()
        self.root = nn.Sequential(OrderedDict([
            ("conv", StdConv2d(3, width, 7, stride=2, padding=3,
                               bias=False)),
            ("gn", nn.GroupNorm(32, width, eps=1e-6)),
            ("relu", nn.ReLU())]))
        stages, cin = [], width
        for s, n in enumerate(units):
            cout = width * 4 * 2 ** s
            units_ = [("unit1", PreActBottleneck(cin, cout, cout // 4,
                                                 1 if s == 0 else 2))]
            units_ += [(f"unit{i}", PreActBottleneck(cout, cout, cout // 4))
                       for i in range(2, n + 1)]
            stages.append((f"block{s + 1}", nn.Sequential(OrderedDict(units_))))
            cin = cout
        self.body = nn.Sequential(OrderedDict(stages))

    def forward(self, x):
        size = x.shape[2]
        features = []
        x = self.root(x)
        features.append(x)
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=0)
        for i in range(len(self.body) - 1):
            x = self.body[i](x)
            right = int(size / 4 / (i + 1))
            pad = right - x.shape[2]
            features.append(F.pad(x, (0, pad, 0, pad)) if pad else x)
        return self.body[-1](x), features[::-1]


class Embeddings(nn.Module):
    def __init__(self, img_size, hidden, units, width):
        super().__init__()
        n = (img_size // 16) ** 2
        self.hybrid_model = ResNetV2(units, width)
        self.patch_embeddings = Conv2d(width * 16, hidden, 1)
        self.position_embeddings = nn.Parameter(torch.zeros(1, n, hidden))

    def forward(self, x):
        x, features = self.hybrid_model(x)
        x = self.patch_embeddings(x).flatten(2).transpose(1, 2)
        return x + self.position_embeddings, features


class Attention(nn.Module):
    def __init__(self, hidden, heads):
        super().__init__()
        self.heads, self.d = heads, hidden // heads
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)
        self.out = Linear(hidden, hidden)

    def forward(self, x):
        b, n, c = x.shape

        def split(t):
            return t.view(b, n, self.heads, self.d).permute(0, 2, 1, 3)

        q, k, v = split(self.query(x)), split(self.key(x)), split(
            self.value(x))
        probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(self.d),
                              dim=-1)
        return self.out((probs @ v).permute(0, 2, 1, 3).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, hidden, mlp):
        super().__init__()
        self.fc1 = Linear(hidden, mlp)
        self.fc2 = Linear(mlp, hidden)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, hidden, heads, mlp):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn = Mlp(hidden, mlp)
        self.attn = Attention(hidden, heads)

    def forward(self, x):
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class Encoder(nn.Module):
    def __init__(self, hidden, layers, heads, mlp):
        super().__init__()
        self.layer = nn.ModuleList(Block(hidden, heads, mlp)
                                   for _ in range(layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=1e-6)

    def forward(self, x):
        for block in self.layer:
            x = block(x)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    def __init__(self, img_size, hidden, layers, heads, mlp, units, width):
        super().__init__()
        self.embeddings = Embeddings(img_size, hidden, units, width)
        self.encoder = Encoder(hidden, layers, heads, mlp)

    def forward(self, x):
        x, features = self.embeddings(x)
        return self.encoder(x), features


def conv_bn_relu(cin, cout):
    return nn.Sequential(Conv2d(cin, cout, 3, padding=1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())


class DecoderBlock(nn.Module):
    def __init__(self, cin, cout, skip):
        super().__init__()
        self.conv1 = conv_bn_relu(cin + skip, cout)
        self.conv2 = conv_bn_relu(cout, cout)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class DecoderCup(nn.Module):
    def __init__(self, hidden, head_channels, decoder, skips):
        super().__init__()
        self.conv_more = conv_bn_relu(hidden, head_channels)
        cins = [head_channels] + list(decoder[:-1])
        self.blocks = nn.ModuleList(DecoderBlock(i, o, s) for i, o, s in
                                    zip(cins, decoder, skips))
        self.n_skip = sum(s > 0 for s in skips)

    def forward(self, x, features):
        b, n, c = x.shape
        g = int(math.isqrt(n))
        x = self.conv_more(x.permute(0, 2, 1).reshape(b, c, g, g))
        for i, block in enumerate(self.blocks):
            x = block(x, features[i] if i < self.n_skip else None)
        return x


class TransUNet(nn.Module):
    def __init__(self, img_size, num_classes, hidden, layers, heads, mlp,
                 units, width, head_channels, decoder, n_skip):
        super().__init__()
        self.transformer = Transformer(img_size, hidden, layers, heads, mlp,
                                       units, width)
        skips = [8 * width, 4 * width, width][:n_skip]
        skips += [0] * (len(decoder) - len(skips))
        self.decoder = DecoderCup(hidden, head_channels, decoder, skips)
        self.segmentation_head = nn.Sequential(
            Conv2d(decoder[-1], num_classes, 3, padding=1), nn.Identity())

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x, features = self.transformer(x)
        x = self.decoder(x, features)
        return self.segmentation_head(x).permute(0, 2, 3, 1)


def build(config):
    m = config["model"]
    if m["dropout_rate"] or m["attention_dropout_rate"]:
        raise ValueError("the reference runs the transformer without "
                         "dropout")
    return TransUNet(config["patch"], config["num_classes"],
                     m["hidden_size"], m["num_layers"], m["num_heads"],
                     m["mlp_dim"], tuple(m["resnet_units"]), m["width"],
                     m["head_channels"], tuple(m["decoder_channels"]),
                     m["n_skip"])


def init_rules(model):
    """Upstream's init: the MLP's weights xavier-uniform, biases N(0,
    1e-6); position embeddings zero; GroupNorm and LayerNorm weight 1,
    bias 0; every other convolution and linear torch's default U(-b, b),
    b = 1/sqrt(fan_in), for weight and bias."""
    rules = {}
    for prefix, m in model.named_modules():
        own = {k: f"{prefix}.{k}" for k, _ in m.named_parameters(
            recurse=False)}
        if isinstance(m, Linear) and prefix.rsplit(".", 1)[-1] in ("fc1",
                                                                  "fc2"):
            fan_out, fan_in = m.weight.shape
            rules[own["weight"]] = ("uniform",
                                    math.sqrt(6.0 / (fan_in + fan_out)))
            rules[own["bias"]] = ("normal", 1e-6)
        elif isinstance(m, (Conv2d, Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for name in own.values():
                rules[name] = ("uniform", bound)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            rules[own["weight"]] = ("const", 1.0)
            rules[own["bias"]] = ("const", 0.0)
        elif "position_embeddings" in own:
            rules[own["position_embeddings"]] = ("const", 0.0)
    return rules
