"""The native boundary-metric engine (the repo's native/boundary.cc)
through ctypes.

`build()` compiles the C++ source with g++ -O3 through
`utils/native_build.py` at first use. A failed build or load raises:
there is no quiet fallback to the scipy version (utils/boundary.py),
which is the engine's plain version for the tests.
"""

import ctypes
import functools
import os

import numpy as np

from ust_run_tpu_torch.utils import native_build

SOURCE = os.path.normpath(os.path.join(native_build.BUILD, os.pardir,
                                       os.pardir, "native", "boundary.cc"))
# no -march=native: a build directory copied to another machine must not
# carry instructions its CPU lacks
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]


def build():
    """Compile native/boundary.cc unless the current build exists; returns
    the library path. Raises with g++'s output on failure."""
    return native_build.build("g++", GXX_FLAGS, SOURCE, "boundary")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(build())
    lib.boundary_metrics.restype = ctypes.c_int
    lib.boundary_metrics.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    return lib


def boundary_metrics(pred, gt):
    """(dc, jc, hd95, asd) for two 2-D masks of one shape.

    hd95 and asd are NaN when either mask is empty; the caller applies the
    reference's empty-prediction convention (train.py:313-315)."""
    pred = np.ascontiguousarray(pred, np.uint8)
    gt = np.ascontiguousarray(gt, np.uint8)
    if pred.ndim != 2 or pred.shape != gt.shape:
        raise ValueError(f"two 2-D masks of one shape expected, got "
                         f"{pred.shape} and {gt.shape}")
    out = np.zeros(4, np.float64)
    _lib().boundary_metrics(
        pred.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        gt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pred.shape[0], pred.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return tuple(float(v) for v in out)
