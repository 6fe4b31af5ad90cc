"""Uniform random fields (counterpart of ust_run_tpu/ops/pallas_rng.py).

`uniform_fields` launches the hand-written CUDA kernel
(csrc/uniform_rng.cu, Philox4x32-10) for a CUDA device and uses
`uniform_batch_plain`, the same Philox in PyTorch integer arithmetic, bit
for bit, only for the CPU. `uniform_batch` draws the 64-bit seed from a
CPU torch.Generator, so no step waits on the device for it.

The kernel reads its key from device memory: a (2,) int32 tensor on the
output's device holding the two 32-bit words of the 64-bit seed
(`key_words`). A captured CUDA graph therefore draws new fields on each
replay once the key there is rewritten (semisup/step.py). A Python int
seed is accepted too, and is copied to the device as its key words.

Values are (w >> 8) * 2^-24 for each 32-bit Philox word w: U[0, 1) on a
2^-24 grid, deterministic per (seed, field), independent across fields.
"""

import ctypes
import functools

import numpy as np
import torch

from ust_run_tpu_torch.utils.device import resolve_device

# Kernel launches that ran (a plain count, reset by callers that want to
# show a run went through the kernel): each launch `uniform_fields` makes
# outside a CUDA graph capture, and each one a replayed graph runs (added
# by semisup/step.py's StepGraph). A launch recorded into a capture runs
# only on replay: `captured` counts those.
launches = 0
captured = 0

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m, x):
    """(hi, lo) 32-bit words of the 64-bit product m * x, x an int64 tensor
    of 32-bit values. The product can exceed int64 (0xD2511F53 *
    0xFFFFFFFF > 2^63), so x is split into 16-bit halves."""
    p1 = m * (x >> 16)                    # < 2^48
    p0 = m * (x & 0xFFFF)                 # < 2^48
    t = ((p1 & 0xFFFF) << 16) + p0        # < 2^49
    lo = t & _MASK32
    hi = ((p1 >> 16) + (t >> 32)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words; k0, k1 ints."""
    for r in range(10):
        if r > 0:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def split_seed(seed):
    """64-bit seed -> Philox key (low word, high word)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK32, seed >> 32


def key_words(seed):
    """64-bit seed -> the (2,) int32 array (bit patterns of the low and
    high words) that a tensor key holds."""
    return np.array(split_seed(seed), np.uint32).view(np.int32)


def _key_ints(key):
    """(k0, k1) of an int seed or a (2,) int32 tensor key."""
    if not torch.is_tensor(key):
        return split_seed(key)
    k0, k1 = (int(v) & _MASK32 for v in key.tolist())
    return k0, k1


def uniform_batch_plain(n, size, key, device="cpu"):
    """The kernel's function in PyTorch: (n, size, size) float32 on
    `device`, `key` an int seed or a (2,) int32 tensor (`key_words`)."""
    return _plain(n, size, *_key_ints(key), device)


def _plain(n, size, k0, k1, device):
    per_field = size * size
    quads = (per_field + 3) // 4
    dev = torch.device(device)
    q = torch.arange(quads, dtype=torch.int64, device=dev)[None, :]
    f = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    c0 = q.expand(n, quads)
    c1 = f.expand(n, quads)
    zero = torch.zeros_like(c0)
    words = torch.stack(philox4x32_10(c0, c1, zero, zero, k0, k1), dim=-1)
    words = words.reshape(n, 4 * quads)[:, :per_field]
    u = (words >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.reshape(n, size, size)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The launch function of csrc/uniform_rng.cu, built at first use."""
    from ust_run_tpu_torch.ops import cuda_build
    fn = cuda_build.load("uniform_rng").uniform_fields_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _device_key(seed, device):
    """An int seed's key words on a CUDA device, copied from pinned
    memory without blocking."""
    if torch.cuda.is_current_stream_capturing():
        raise ValueError("an int seed would be frozen into the captured "
                         "graph: pass a key tensor on the device")
    return torch.from_numpy(key_words(seed)).pin_memory().to(
        device, non_blocking=True)


def uniform_fields(out, key):
    """Fill `out` ((n, S, S) float32, contiguous) with the fields of
    `key`: a contiguous (2,) int32 tensor on `out`'s device (`key_words`)
    or a Python int seed. A CUDA tensor goes through the kernel, which
    reads the key from device memory; a CPU tensor through the plain
    version. Returns `out`."""
    global launches, captured
    if out.dtype != torch.float32 or out.ndim != 3 \
            or out.shape[1] != out.shape[2] or not out.is_contiguous():
        raise ValueError("out must be a contiguous (n, S, S) float32 "
                         f"tensor, got {tuple(out.shape)} {out.dtype}")
    if torch.is_tensor(key) and (key.dtype != torch.int32
                                 or key.shape != (2,)
                                 or not key.is_contiguous()
                                 or key.device != out.device):
        raise ValueError("a tensor key must be a contiguous (2,) int32 "
                         f"tensor on {out.device}, got {tuple(key.shape)} "
                         f"{key.dtype} on {key.device}")
    n, size = out.shape[0], out.shape[1]
    if out.device.type == "cpu":
        return out.copy_(uniform_batch_plain(n, size, key, out.device))
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    if n > 65535:
        raise ValueError(f"at most 65535 fields per launch, got {n}")
    if not torch.is_tensor(key):
        key = _device_key(key, out.device)
    launch = _kernel()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = launch(out.data_ptr(), n, size, key.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"uniform_fields_launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out


def draw_seed(generator):
    """A 63-bit seed from a CPU torch.Generator (no device sync)."""
    if generator.device.type != "cpu":
        raise ValueError("the field seed comes from a CPU torch.Generator")
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))


def draw_key(generator):
    """`draw_seed` as the (2,) int32 words of a tensor key."""
    return key_words(draw_seed(generator))


def uniform_batch(n, size, *, generator, device):
    """(n, size, size) float32 U[0,1) fields on `device`, seeded from the
    CPU `generator` (the seed goes to the device as its key words). CUDA
    launches the kernel; "cpu" uses the plain version; a CUDA request
    without CUDA raises."""
    dev = resolve_device(device)
    out = torch.empty((n, size, size), dtype=torch.float32, device=dev)
    return uniform_fields(out, draw_seed(generator))
