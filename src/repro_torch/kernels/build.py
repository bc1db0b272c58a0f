"""Build the port's CUDA kernels at first use: ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``.

Sources live beside their wrappers (``kernels/<name>/csrc/*.cu``).  The
library lands in ``kernels/_build/`` (listed in ``.gitignore``) under a name
keyed by the sources' content and the compiler flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  The compiler's
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is kept
beside the library as ``<name>.log``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

__all__ = ["BUILD_DIR", "ARCH_FLAGS", "build_library", "nvcc_path"]

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

#: Hopper with the arch-specific features (``wgmma``, ``setmaxnreg``).
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v")


def nvcc_path() -> str:
    """``$NVCC``, else ``nvcc`` on the PATH, else the toolkit's default."""
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set $NVCC or put the CUDA toolkit on the PATH); "
        "the port's CUDA kernels are built on the machine with the card"
    )


def build_library(name: str, sources: list[str]) -> str:
    """Path of ``lib<name>-<key>.so`` built from ``sources``, compiling it
    first when this content has not been built yet."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *_FLAGS, "-o", tmp, *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)      # atomic: a concurrent loader never sees half
    return out
