"""Fused BN-apply + ReLU + 3x3 conv with a per-sample moment epilogue
(counterpart of ust_run_tpu/ops/fused_conv.py).

    out    = conv3x3_same(relu(y * inv_n - shift_n), w)
    m1, m2 = per-sample mean and mean-square of the f32 accumulator

`bn_relu_conv3x3` launches the hand-written CUDA kernel
(csrc/fused_conv.cu, deterministic two-pass moments) for CUDA tensors and
uses `bn_relu_conv3x3_plain`, the same arithmetic step by step in
PyTorch, only for CPU tensors. The library has two routes, picked by
shape before the launch (`plan`): "tma_wgmma" (bf16 with C and Co
multiples of 8: TMA loads, an mbarrier ring, wgmma, 16x16-pixel tiles)
and "wmma" (f32, and bf16 at other channel counts: synchronous loads,
WMMA or f32 FMA, 8x16-pixel tiles).
`reference_chain` is the counterpart of `xla_reference_chain`: the op
chain the kernel replaces (BN+ReLU in y's dtype, a library convolution,
moments of the rounded output), for tests and as the timing yardstick.

Layouts are the JAX package's: y NHWC (B, H, W, C), w HWIO (3, 3, C, Co),
inv_n / shift_n (B, C) f32; out (B, H, W, Co) in y's dtype, m1 / m2
(B, Co) f32. The TPU tiling knob `block_rows` and the P = 128/C channel
fold (a TPU lane rule) have no counterpart here.

Like the JAX op, nothing in the model calls this: its path is the op, its
tests and the microbench phase of chip_smoke.py.
"""

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

# Kernel launches made by `bn_relu_conv3x3` (plain counts, reset by callers
# that want to show a run went through the kernel): in all, and per route.
launches = 0
route_launches = [0, 0]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wmma", "tma_wgmma")
# output rows and columns of one tile, per route (csrc/fused_conv.cu)
TILES = ((8, 16), (16, 16))


class Plan(NamedTuple):
    """The geometry of one launch: its route, the output rows, columns and
    channels of a tile, the input channels of one K chunk, and the tiles
    per sample (the moment scratch holds one slot per tile)."""
    route: int
    tile_h: int
    tile_w: int
    tile_n: int
    tile_k: int
    tiles: int


def plan(dtype, c, co, h, w):
    """The library's launch rule, which the wrapper checks against the
    library on the card. Route 1 (TMA + wgmma) needs bf16 and 16-byte row
    strides for its tensor maps (C and Co multiples of 8); it takes 64
    channels per K chunk and 64 output channels per tile where Co <= 64,
    else 128. Route 0 takes the rest, 64 output channels per tile and 32
    (bf16) or 16 (f32) per K chunk."""
    route = int(dtype == torch.bfloat16 and c % 8 == 0 and co % 8 == 0)
    th, tw = TILES[route]
    if route == 1:
        tn, tk = (64 if co <= 64 else 128), 64
    else:
        tn, tk = 64, (32 if dtype == torch.bfloat16 else 16)
    return Plan(route, th, tw, tn, tk, -(-h // th) * -(-w // tw))


def _bn_relu(y, inv_n, shift_n):
    """relu(y * inv - shift) in f32, rounded to y's dtype (fused_conv.py
    :87-92)."""
    a = y.float() * inv_n[:, None, None, :].float() \
        - shift_n[:, None, None, :].float()
    return torch.clamp_min(a, 0.0).to(y.dtype)


def bn_relu_conv3x3_plain(y, inv_n, shift_n, w):
    """The kernel's function in PyTorch, step by step: BN+ReLU in f32
    rounded to y's dtype, zero padding in the post-BN domain, nine f32 tap
    products accumulated in f32, `out` rounded to y's dtype, moments of
    the f32 accumulator over H*W."""
    B, H, W, _ = y.shape
    a = F.pad(_bn_relu(y, inv_n, shift_n).float(), (0, 0, 1, 1, 1, 1))
    wk = w.to(y.dtype).float()
    acc = torch.zeros((B, H, W, w.shape[-1]), dtype=torch.float32,
                      device=y.device)
    for di in range(3):
        for dj in range(3):
            acc += torch.matmul(a[:, di:di + H, dj:dj + W, :], wk[di, dj])
    hw = float(H * W)
    return (acc.to(y.dtype), acc.sum(dim=(1, 2)) / hw,
            torch.square(acc).sum(dim=(1, 2)) / hw)


def reference_chain(y, inv_n, shift_n, w):
    """The op chain the kernel replaces (xla_reference_chain,
    fused_conv.py:223-237): BN+ReLU in y's dtype, a 3x3 'same' library
    convolution accumulating in f32, moments of the rounded output. On a
    card the convolution runs in y's dtype (cuDNN accumulates in f32); on
    the CPU it runs in f32 and is rounded afterwards."""
    dt = y.dtype
    a = torch.clamp_min(y * inv_n[:, None, None, :].to(dt)
                        - shift_n[:, None, None, :].to(dt), 0)
    x = a.permute(0, 3, 1, 2)                       # NCHW, channels_last
    wk = w.to(dt).permute(3, 2, 0, 1)               # (Co, C, 3, 3)
    if y.device.type == "cuda":
        out = F.conv2d(x, wk, padding=1)
    else:
        out = F.conv2d(x.float(), wk.float(), padding=1).to(dt)
    out = out.permute(0, 2, 3, 1)
    o32 = out.float()
    return out, o32.mean(dim=(1, 2)), torch.square(o32).mean(dim=(1, 2))


@functools.lru_cache(maxsize=None)
def _lib():
    """The ctypes functions of csrc/fused_conv.cu, built at first use."""
    from ust_run_tpu_torch.ops import cuda_build
    lib = cuda_build.load("fused_conv")
    for name, n_args in (("route", 3), ("tile_h", 1), ("tile_w", 1),
                         ("tile_n", 2), ("tile_k", 2), ("tiles", 3)):
        fn = getattr(lib, "bn_relu_conv3x3_" + name)
        fn.argtypes = [ctypes.c_int] * n_args
        fn.restype = ctypes.c_int
    fn = lib.bn_relu_conv3x3_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(y, inv_n, shift_n, w):
    if y.ndim != 4 or y.dtype not in _DTYPES:
        raise ValueError("y must be (B, H, W, C) float32 or bfloat16, got "
                         f"{tuple(y.shape)} {y.dtype}")
    B, _, _, C = y.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be (3, 3, {C}, Co), got {tuple(w.shape)}")
    for name, t in (("inv_n", inv_n), ("shift_n", shift_n)):
        if tuple(t.shape) != (B, C) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B}, {C}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    devices = {t.device for t in (y, inv_n, shift_n, w)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


@functools.lru_cache(maxsize=None)
def library_plan(dtype, c, co, h, w):
    """`plan` as the built library answers it; raises where the two
    disagree."""
    lib = _lib()
    route = lib.bn_relu_conv3x3_route(_DTYPES[dtype], c, co)
    answer = Plan(route, lib.bn_relu_conv3x3_tile_h(route),
                  lib.bn_relu_conv3x3_tile_w(route),
                  lib.bn_relu_conv3x3_tile_n(route, co),
                  lib.bn_relu_conv3x3_tile_k(_DTYPES[dtype], route),
                  lib.bn_relu_conv3x3_tiles(route, h, w))
    if answer != plan(dtype, c, co, h, w):
        raise RuntimeError(f"fused_conv library plans {answer} for "
                           f"{(dtype, c, co, h, w)}, ops/fused_conv.py "
                           f"{plan(dtype, c, co, h, w)}")
    return answer


def bn_relu_conv3x3(y, inv_n, shift_n, w):
    """(out, m1, m2) of the fused op. A CUDA tensor goes through the
    kernel (which raises if it does not build or launch); a CPU tensor
    through the plain version."""
    global launches
    _check(y, inv_n, shift_n, w)
    if y.device.type == "cpu":
        return bn_relu_conv3x3_plain(y, inv_n, shift_n, w)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    B, H, W, C = y.shape
    co = w.shape[-1]
    geom = library_plan(y.dtype, C, co, H, W)
    route = geom.route
    if route == 0 and B > 65535:
        raise ValueError(f"at most 65535 samples per launch, got {B}")
    y = y.contiguous()
    if route == 1:
        # tensor maps need 16-byte-aligned bases; w goes K-major (9, Co, C)
        if y.data_ptr() % 16:
            y = y.clone()
        wk = w.to(y.dtype).reshape(9, C, co).transpose(1, 2).contiguous()
    else:
        wk = w.to(y.dtype).reshape(9, C, co).contiguous()
    inv_n = inv_n.contiguous()
    shift_n = shift_n.contiguous()
    out = torch.empty((B, H, W, co), dtype=y.dtype, device=y.device)
    m = torch.empty((2, B, co), dtype=torch.float32, device=y.device)
    part = torch.empty((2, B, geom.tiles, co), dtype=torch.float32,
                       device=y.device)
    lib = _lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.bn_relu_conv3x3_launch(
            _DTYPES[y.dtype], y.data_ptr(), inv_n.data_ptr(),
            shift_n.data_ptr(), wk.data_ptr(), out.data_ptr(),
            m[0].data_ptr(), m[1].data_ptr(), part.data_ptr(), B, H, W, C,
            co, stream)
    if err != 0:
        raise RuntimeError(f"bn_relu_conv3x3_launch failed: CUDA error {err}")
    launches += 1
    route_launches[route] += 1
    return out, m[0], m[1]
