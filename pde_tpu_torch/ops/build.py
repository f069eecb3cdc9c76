"""Build the package's CUDA sources into shared libraries, at first use.

The one module of the port without a twin in ``pde_tpu``: JAX's Pallas
kernels compile inside XLA, while the port's kernels are CUDA C++ for
Hopper (``sm_90a``) with a plain C interface.  ``nvcc`` compiles them into
``build/pde_tpu_torch/`` beside the package, keyed by a hash of the
sources and flags, and ``ctypes`` loads the result.  A missing ``nvcc`` or
a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "load_library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "pde_tpu_torch"
# no --use_fast_math: expf and division stay IEEE; nvcc's default FMA
# contraction stays on
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of pde_tpu_torch are "
                       "built from source and need the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> tuple[ctypes.CDLL, str]:
    """Build ``csrc/<source>`` (cached by content) and load it.

    Returns the library and the compiler's log (``-Xptxas -v`` reports each
    kernel's registers and spills).
    """
    src = CSRC / source
    text = src.read_bytes()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{src.stem}-{key}.so"
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib_path)), log
