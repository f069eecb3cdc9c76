"""Build the package's CUDA sources into shared libraries, at first use.

The one module of the port without a twin in ``pde_tpu``: JAX's Pallas
kernels compile inside XLA, while the port's kernels are CUDA C++ for
Hopper (``sm_90a``) with a plain C interface.  ``nvcc`` compiles them into
``build/pde_tpu_torch/`` beside the package, keyed by a hash of the
sources, the shared headers (``csrc/*.cuh``) and the flags, and ``ctypes``
loads the result.  A missing ``nvcc`` or
a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCE_FLAGS", "load_library",
           "load_libraries"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "pde_tpu_torch"
# no --use_fast_math: expf and division stay IEEE; nvcc's default FMA
# contraction stays on
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per source, on top: these kernels round every product and sum on its
# own, as their plain twins do (no FMA contraction), so kernel and twin
# agree bit for bit; for the 1D theta-scheme marches the float32 round-off
# alone is of the size of the kernel-vs-twin gate (K4 sat 1.09x past it
# with contraction).  K1 (adi_fused_batched.cu), K2 (adi_fused.cu) and K3
# (cn1d_tv_fused.cu) keep nvcc's contraction: their lane-group scans
# already compose the values entering each chunk in another order than the
# twins, each ran faster with it in a one-off comparison of both builds in
# one call on one H100 (K2: its shared-memory route, in turns), and
# chip_smoke.py holds them well inside the gate with it
SOURCE_FLAGS = {src: ("-fmad=false",) for src in (
    "cn1d_fused.cu", "thomas_batched.cu", "psor_batched.cu")}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of pde_tpu_torch are "
                       "built from source and need the CUDA toolkit")


_LOADED: dict[str, tuple[ctypes.CDLL, str]] = {}


def load_libraries(*sources: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Build each ``csrc/<source>`` not built yet (cached by content), all
    ``nvcc`` processes started together, and load them.

    Returns ``{source: (library, compiler log)}``; ``-Xptxas -v`` in the
    log reports each kernel's registers and spills (empty for a library
    found already built).
    """
    todo = []
    # every source may include the shared headers: they join each key
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    for source in sources:
        if source in _LOADED:
            continue
        src = CSRC / source
        flags = NVCC_FLAGS + SOURCE_FLAGS.get(source, ())
        key = hashlib.sha256(src.read_bytes() + headers
                             + " ".join(flags).encode()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"{src.stem}-{key}.so"
        todo.append((source, src, lib_path, flags))
    jobs = []
    try:
        for source, src, lib_path, flags in todo:
            if lib_path.exists():
                jobs.append((source, lib_path, None, None))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([_nvcc(), *flags, "-o", tmp, str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((source, lib_path, tmp, proc))
        for source, lib_path, tmp, proc in jobs:
            log = ""
            if proc is not None:
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {CSRC / source}:\n{log}")
                os.replace(tmp, lib_path)
            _LOADED[source] = (ctypes.CDLL(str(lib_path)), log)
    finally:
        for _, _, tmp, proc in jobs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
    return {source: _LOADED[source] for source in sources}


def load_library(source: str) -> tuple[ctypes.CDLL, str]:
    """Build ``csrc/<source>`` (cached by content) and load it: the library
    and the compiler's log."""
    return load_libraries(source)[source]
