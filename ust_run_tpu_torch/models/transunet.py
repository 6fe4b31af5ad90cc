"""TransUNet, R50-ViT-B/16 (Chen et al., arXiv:2102.04306; upstream
github.com/Beckschen/TransUNet: networks/vit_seg_modeling.py,
vit_seg_modeling_resnet_skip.py, vit_seg_configs.py:get_r50_b16_config).
The JAX package has no transformer: this model is the port's own.

  * Input: a 1-channel image is repeated to 3 channels.
  * Hybrid stem (ResNetV2): every convolution a StdConv2d (the weight
    standardised per output channel at each forward, biased variance,
    eps 1e-5); root 7x7/2 3->width, GroupNorm(32, eps 1e-6), ReLU; a
    3x3/2 max pool with no padding (384 -> 95); three stages of
    pre-activation bottlenecks, `units` (3, 4, 9) at widths 4, 8 and 16
    times `width`, the stride 2 on the first unit's 3x3. A unit is
    relu(gn_proj(down(x)) + gn3(conv3(relu(gn2(conv2(relu(gn1(conv1(x)))))))))
    with the projection (1x1 StdConv, GroupNorm(cout, cout)) only where
    the stride or the width changes. Skips, finest last: stage 2's output,
    stage 1's zero-padded at the bottom and right to in_size / 4 (95 ->
    96 at 384, as upstream pads it), and the root's.
  * Embeddings: a 1x1 convolution with bias to `hidden` on the 1/16 grid
    (576 tokens at 384), plus the position embeddings.
  * Encoder: `layers` pre-LN blocks, x += attn(LN(x)); x += mlp(LN(x)),
    LayerNorm eps 1e-6; attention of `heads` heads (ops/attention.py),
    query/key/value/out linears with bias; MLP hidden -> mlp, exact GELU,
    -> hidden; `encoder_norm` after the last block.
  * DecoderCup: tokens back to a map, conv_more (3x3 hidden -> 512, BN,
    ReLU), then blocks of a bilinear x2 upsample (align_corners=True),
    the skip concatenated after the upsampled map, and two 3x3
    Conv-BN-ReLU; segmentation head a 3x3 convolution with bias.

Dropout is left out: the published transformer dropout (0.1) would
randomise the EMA teacher's pseudo-labels, since the step runs the
teacher in train mode (semisup/step.py:teacher_forward).

Module names and state_dict keys are upstream's
(`transformer.embeddings.hybrid_model.*`, `transformer.embeddings.
{patch_embeddings,position_embeddings}`, `transformer.encoder.layer.{i}.
{attention_norm,attn.{query,key,value,out},ffn_norm,ffn.{fc1,fc2}}`,
`transformer.encoder.encoder_norm`, `decoder.conv_more.{0,1}`,
`decoder.blocks.{i}.conv{1,2}.{0,1}`, `segmentation_head.0`).

The forward keeps the models' contract: NHWC float32 in, NHWC float32
logits out, channels_last inside but in the stem, `groups`/
`group_sizes`/`group_valid` passed to every decoder BatchNorm
(GroupedBatchNorm with its ReLU); the GroupNorms and LayerNorms
normalise each sample alone and need no groups. With `amp` the encoder
and the decoder run under bf16 autocast with float32 parameters
(autocast keeps LayerNorm in float32, and flash attention keeps its
softmax statistics in float32), and the hybrid stem runs in float32
outside it, in NCHW memory. The stem's weight standardisation and
GroupNorms leave its loss nearly unchanged by a shift or a scale of each
unit's input, so the gradients of its GroupNorm weights and biases are
small sums of large terms that cancel: on the H100 at the published
size, bf16 operands there leave 39-45% of the worst such gradient's norm
to rounding against the float32 reference (the float32 model reads
5e-3), and a float32 stem 3-7%. The upsampling is the matrix-product
resize of models/deeplab.py (F.interpolate's CUDA backward adds with
atomics). The encoder, from the patch embedding through `encoder_norm`,
is the clocked span `model.vit` (utils/trace.py), which clocks only
inside a step's stage; the hybrid stem stays in the enclosing stage.

No mesh: TransUNet runs on one device, and a model bound to a mesh
(parallel.bind_mesh) raises at its forward.
"""

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ust_run_tpu_torch.models.deeplab import resize_align_corners
from ust_run_tpu_torch.models.layers import GroupedBatchNorm
from ust_run_tpu_torch.ops import attention
from ust_run_tpu_torch.parallel import spatial
from ust_run_tpu_torch.utils.trace import span

# get_r50_b16_config at the published widths (build_model reads it)
R50_VIT_B16 = dict(hidden=768, layers=12, heads=12, mlp=3072,
                   units=(3, 4, 9), width=64, head_channels=512,
                   decoder=(256, 128, 64, 16), n_skip=3)


class StdConv2d(nn.Conv2d):
    """A convolution of the weight standardised per output channel. The
    stem runs in NCHW (torch's GroupNorm copies a channels_last input to
    NCHW on CUDA), so the weight takes NCHW strides too, even where a 1x1
    weight's strides fit both layouts: a weight with channels_last strides
    makes the convolution's output channels_last."""

    def forward(self, x):
        v, m = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True,
                              correction=0)
        w = (self.weight - m) / torch.sqrt(v + 1e-5)
        return self._conv_forward(
            x, w.clone(memory_format=torch.contiguous_format), self.bias)


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
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride=stride,
                                        bias=False)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x):
        residual = x
        if hasattr(self, "downsample"):
            residual = self.gn_proj(self.downsample(x))
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
            ("relu", nn.ReLU(inplace=True))]))
        blocks, cin = [], width
        for b, (n, mult) in enumerate(zip(units, (4, 8, 16))):
            cout, stride = width * mult, 1 if b == 0 else 2
            unit = [("unit1", PreActBottleneck(cin, cout, cout // 4, stride))]
            unit += [(f"unit{i}", PreActBottleneck(cout, cout, cout // 4))
                     for i in range(2, n + 1)]
            blocks.append((f"block{b + 1}", nn.Sequential(OrderedDict(unit))))
            cin = cout
        self.body = nn.Sequential(OrderedDict(blocks))

    def forward(self, x):
        """NCHW -> (the 1/16 map, [skips, coarsest first])."""
        size = x.shape[2]
        x = self.root(x)
        features = [x]
        x = F.max_pool2d(x, 3, 2, 0)
        for i, block in enumerate(self.body[:-1]):
            x = block(x)
            right = int(size / 4 / (i + 1))
            pad = right - x.shape[2]
            if pad:
                assert 0 < pad < 3, (tuple(x.shape), right)
                features.append(F.pad(x, (0, pad, 0, pad)))
            else:
                features.append(x)
        return self.body[-1](x), features[::-1]


class Embeddings(nn.Module):
    """The hybrid stem (under upstream's key `hybrid_model`, run by
    Transformer.forward) and the token embedding of its output."""

    def __init__(self, img_size, hidden, units, width):
        super().__init__()
        grid = img_size // 16
        self.hybrid_model = ResNetV2(units, width)
        self.patch_embeddings = nn.Conv2d(width * 16, hidden, 1)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, grid * grid, hidden))

    def forward(self, x):
        """The stem's (B, C, g, g) map -> (B, g*g, hidden) tokens."""
        x = self.patch_embeddings(x)
        b, c = x.shape[:2]
        return x.permute(0, 2, 3, 1).reshape(b, -1, c) \
            + self.position_embeddings


class Attention(nn.Module):
    def __init__(self, hidden, heads):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x):
        b, n, c = x.shape

        def heads(t):
            return t.view(b, n, self.heads, c // self.heads).transpose(1, 2)

        ctx = attention.attention(heads(self.query(x)), heads(self.key(x)),
                                  heads(self.value(x)))
        return self.out(ctx.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, hidden, mlp):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp)
        self.fc2 = nn.Linear(mlp, hidden)

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
        """NCHW image -> ((B, tokens, hidden), skips); the stem in float32
        and NCHW memory whatever the autocast and the layout around it."""
        with torch.autocast(device_type=x.device.type, enabled=False):
            x, features = self.embeddings.hybrid_model(
                x.float().contiguous())
        with span("model.vit", x.device):
            return self.encoder(self.embeddings(x)), features


class Conv2dReLU(nn.Sequential):
    """3x3 convolution without bias, BatchNorm and ReLU (the ReLU inside
    the GroupedBatchNorm)."""

    def __init__(self, cin, cout):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                         GroupedBatchNorm(cout))

    def forward(self, x, **gkw):
        conv, bn = self
        return bn(conv(x), relu=True, **gkw)


class DecoderBlock(nn.Module):
    def __init__(self, cin, cout, skip):
        super().__init__()
        self.conv1 = Conv2dReLU(cin + skip, cout)
        self.conv2 = Conv2dReLU(cout, cout)

    def forward(self, x, skip=None, **gkw):
        h, w = x.shape[2:]
        x = resize_align_corners(x, 2 * h, 2 * w)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype,
                                      memory_format=torch.channels_last)],
                          dim=1)
        return self.conv2(self.conv1(x, **gkw), **gkw)


class DecoderCup(nn.Module):
    def __init__(self, hidden, head_channels, decoder, skips):
        super().__init__()
        self.conv_more = Conv2dReLU(hidden, head_channels)
        cins = (head_channels,) + tuple(decoder[:-1])
        self.blocks = nn.ModuleList(DecoderBlock(i, o, s) for i, o, s in
                                    zip(cins, decoder, skips))
        self.n_skip = sum(s > 0 for s in skips)

    def forward(self, tokens, features, **gkw):
        b, n, c = tokens.shape
        g = int(round(n ** 0.5))
        x = self.conv_more(tokens.reshape(b, g, g, c).permute(0, 3, 1, 2),
                           **gkw)
        for i, block in enumerate(self.blocks):
            x = block(x, features[i] if i < self.n_skip else None, **gkw)
        return x


class TransUNet(spatial.SlabAware):
    def __init__(self, n_channels, n_classes, img_size, hidden=768,
                 layers=12, heads=12, mlp=3072, units=(3, 4, 9), width=64,
                 head_channels=512, decoder=(256, 128, 64, 16), n_skip=3,
                 amp=False):
        super().__init__()
        self.n_channels = n_channels
        self.n_classes = n_classes
        self.amp = amp
        self.transformer = Transformer(img_size, hidden, layers, heads, mlp,
                                       tuple(units), width)
        skips = (8 * width, 4 * width, width)[:n_skip]
        skips += (0,) * (len(decoder) - len(skips))
        self.decoder = DecoderCup(hidden, head_channels, tuple(decoder),
                                  skips)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder[-1], n_classes, 3, padding=1))

    def init_weights_(self, generator):
        """Upstream's initialisation, drawn from `generator` in module
        order: the MLP's weights xavier-uniform and biases N(0, 1e-6), the
        position embeddings zero, every other convolution and linear
        torch's default U(-b, b), b = 1/sqrt(fan_in), for weight and
        bias; the norms keep weight 1 and bias 0."""
        mlp = {id(fc) for m in self.modules() if isinstance(m, Mlp)
               for fc in (m.fc1, m.fc2)}
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, Mlp):
                    for fc in (mod.fc1, mod.fc2):
                        fan_out, fan_in = fc.weight.shape
                        b = (6.0 / (fan_in + fan_out)) ** 0.5
                        fc.weight.uniform_(-b, b, generator=generator)
                        fc.bias.normal_(0.0, 1e-6, generator=generator)
                elif isinstance(mod, (nn.Conv2d, nn.Linear)) \
                        and id(mod) not in mlp:
                    b = mod.weight[0].numel() ** -0.5
                    mod.weight.uniform_(-b, b, generator=generator)
                    if mod.bias is not None:
                        mod.bias.uniform_(-b, b, generator=generator)
            self.transformer.embeddings.position_embeddings.zero_()
        return self

    def forward(self, x, groups=1, group_sizes=None, group_valid=None):
        """x: (B, H, W, C) NHWC -> f32 logits (B, H, W, n_classes)."""
        if self.mesh is not None:
            raise ValueError("TransUNet runs on one device: a mesh (data or "
                             "space axis) is out of its scope")
        gkw = dict(groups=groups, group_sizes=group_sizes,
                   group_valid=group_valid)
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3).contiguous()
        x = x.permute(0, 3, 1, 2)          # NCHW view, channels_last memory
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=self.amp, cache_enabled=False):
            tokens, features = self.transformer(x)
            y = self.decoder(tokens, features, **gkw)
            logits = self.segmentation_head(y)
        return logits.float().permute(0, 2, 3, 1)

