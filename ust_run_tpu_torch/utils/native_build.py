"""Compiles the port's native libraries from the checkout at first use.

Each library is one source file compiled into `ust_run_tpu_torch/_build/`
(listed in .gitignore), under a name that carries a hash of the source
and the flags, so an edited source is rebuilt. Nothing is built when a
module is imported: the CPU tests import every module. A failed build
raises with the compiler's output.
"""

import hashlib
import os
import subprocess

BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "_build")


def build(compiler, flags, src, stem):
    """`compiler *flags src -o lib<stem>-<hash>.so` unless that library
    exists; returns its path."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    lib = os.path.join(BUILD, f"lib{stem}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    out = subprocess.run([compiler, *flags, src, "-o", tmp],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed for {src}:"
                           f"\n{out.stdout}\n{out.stderr}")
    with open(f"{lib}.log", "w") as f:
        f.write(out.stdout + out.stderr)
    os.replace(tmp, lib)
    return lib
