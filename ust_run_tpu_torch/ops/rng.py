"""Uniform random fields (counterpart of ust_run_tpu/ops/pallas_rng.py).

`uniform_fields` launches the hand-written CUDA kernel
(csrc/uniform_rng.cu, Philox4x32-10) for a CUDA device and uses
`uniform_batch_plain`, the same Philox in PyTorch integer arithmetic, bit
for bit, only for the CPU. `uniform_batch` draws the 64-bit seed from a
CPU torch.Generator, so no step waits on the device for it.

Values are (w >> 8) * 2^-24 for each 32-bit Philox word w: U[0, 1) on a
2^-24 grid, deterministic per (seed, field), independent across fields.
"""

import ctypes
import functools

import torch

from ust_run_tpu_torch.utils.device import resolve_device

# Kernel launches made by `uniform_fields` (a plain count, reset by callers
# that want to show a run went through the kernel).
launches = 0

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


def uniform_batch_plain(n, size, seed, device="cpu"):
    """The kernel's function in PyTorch: (n, size, size) float32."""
    k0, k1 = split_seed(seed)
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
                   ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def uniform_fields(out, seed):
    """Fill `out` ((n, S, S) float32, contiguous) with the fields of
    `seed`. A CUDA tensor goes through the kernel; a CPU tensor through
    the plain version. Returns `out`."""
    global launches
    if out.dtype != torch.float32 or out.ndim != 3 \
            or out.shape[1] != out.shape[2] or not out.is_contiguous():
        raise ValueError("out must be a contiguous (n, S, S) float32 "
                         f"tensor, got {tuple(out.shape)} {out.dtype}")
    n, size = out.shape[0], out.shape[1]
    if out.device.type == "cpu":
        return out.copy_(uniform_batch_plain(n, size, seed, out.device))
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    if n > 65535:
        raise ValueError(f"at most 65535 fields per launch, got {n}")
    k0, k1 = split_seed(seed)
    launch = _kernel()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = launch(out.data_ptr(), n, size, k0, k1, stream)
    if err != 0:
        raise RuntimeError(f"uniform_fields_launch failed: CUDA error {err}")
    launches += 1
    return out


def draw_seed(generator):
    """A 63-bit seed from a CPU torch.Generator (no device sync)."""
    if generator.device.type != "cpu":
        raise ValueError("the field seed comes from a CPU torch.Generator")
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))


def uniform_batch(n, size, *, generator, device):
    """(n, size, size) float32 U[0,1) fields on `device`, seeded from the
    CPU `generator`. CUDA launches the kernel; "cpu" uses the plain
    version; a CUDA request without CUDA raises."""
    dev = resolve_device(device)
    out = torch.empty((n, size, size), dtype=torch.float32, device=dev)
    return uniform_fields(out, draw_seed(generator))
