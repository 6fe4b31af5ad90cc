"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each library is one `.cu` file under `ust_run_tpu_torch/csrc/` with a
plain C interface, compiled by nvcc for sm_90a through
`utils/native_build.py` (hashed name under `ust_run_tpu_torch/_build/`;
ptxas's register, shared-memory and spill report per kernel, from
`-Xptxas -v`, in `<library>.log` beside it).
"""

import ctypes
import os
import shutil

from ust_run_tpu_torch.utils import native_build

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return found


def build(name):
    """Compile csrc/<name>.cu unless the current build exists; returns the
    library path. Raises with nvcc's output on failure."""
    return native_build.build(_nvcc(), NVCC_FLAGS,
                              os.path.join(CSRC, name + ".cu"), name)


def load(name):
    """ctypes handle of csrc/<name>.cu, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name))
    return _loaded[name]
