"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each library is one `.cu` file under `ust_run_tpu_torch/csrc/` with a
plain C interface, compiled by nvcc for sm_90a into
`ust_run_tpu_torch/_build/` (listed in .gitignore). The file name carries
a hash of the source, so an edited kernel is rebuilt. Nothing is built
when a module is imported: the CPU tests import every module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

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


def library_path(name):
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name):
    """Compile csrc/<name>.cu unless the current build exists; returns the
    library path. Raises with nvcc's output on failure."""
    src, lib = library_path(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(name):
    """ctypes handle of csrc/<name>.cu, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name))
    return _loaded[name]
