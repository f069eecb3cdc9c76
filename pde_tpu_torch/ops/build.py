"""Build the package's CUDA sources into shared libraries, at first use.

The one module of the port without a twin in ``pde_tpu``: JAX's Pallas
kernels compile inside XLA, while the port's kernels are CUDA C++ for
Hopper (``sm_90a``) with a plain C interface.  ``nvcc`` compiles them into
``build/pde_tpu_torch/`` beside the package, keyed by a hash of the
sources, the shared headers (``csrc/*.cuh``) and the flags, and ``ctypes``
loads the result.  A missing ``nvcc`` or
a failed build raises; nothing falls back.

:func:`refuse_autograd` is the guard every kernel wrapper takes first: the
kernels have no backward.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCE_FLAGS", "VARIANTS", "load_library",
           "load_libraries", "refuse_autograd"]

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
# a source built a second time, under a name of its own, with more flags:
# K1's first design launches from a build without FMA contraction, so that
# it rounds every product and sum as the plain twin does and equals it bit
# for bit (with contraction it sat up to 3x past the kernel-vs-twin gate on
# 200x100 at nodes near zero beside values of a few hundred, where the
# contracted kernel was the closer of the two to float64); K1's
# shared-memory routes launch from the default build
VARIANTS = {"adi_fused_batched.cu@exact": ("adi_fused_batched.cu", ("-fmad=false",))}


NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"   # where the CUDA toolkit puts it


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError("nvcc not found: the CUDA kernels of pde_tpu_torch are "
                       "built from source and need the CUDA toolkit")


_LOADED: dict[str, tuple[ctypes.CDLL, str]] = {}


def load_libraries(*sources: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Build each ``csrc/<source>`` (or each build of :data:`VARIANTS`)
    not built yet (cached by content), all ``nvcc`` processes started
    together, and load them.

    Returns ``{source: (library, compiler log)}``; ``-Xptxas -v`` in the
    log reports each kernel's registers and spills (empty for a library
    found already built).
    """
    todo = []
    headers = None
    for source in sources:
        if source in _LOADED:
            continue
        if headers is None:
            # every source may include the shared headers: they join each key
            headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        file, extra = VARIANTS.get(source, (source, ()))
        src = CSRC / file
        flags = NVCC_FLAGS + SOURCE_FLAGS.get(file, ()) + extra
        key = hashlib.sha256(src.read_bytes() + headers
                             + " ".join(flags).encode()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"{src.stem}-{key}.so"
        todo.append((source, src, lib_path, flags))
    jobs = []
    try:
        for source, src, lib_path, flags in todo:
            if lib_path.exists():
                jobs.append((source, src, lib_path, None, None))
                continue
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *flags, "-o", tmp, str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((source, src, lib_path, tmp, proc))
        for source, src, lib_path, tmp, proc in jobs:
            log = ""
            if proc is not None:
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src}:\n{log}")
                os.replace(tmp, lib_path)
            _LOADED[source] = (ctypes.CDLL(str(lib_path)), log)
    finally:
        for _, _, _, tmp, proc in jobs:
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


def refuse_autograd(kernel: str, *inputs) -> None:
    """Raise when autograd would have to run through ``kernel``.

    A kernel writes its result into a fresh tensor through ctypes, so the
    result has no ``grad_fn``; a readout that mixed it with terms that do
    carry gradients would return a wrong gradient without a word.  The
    reference's ``pallas_call`` has no JVP rule and raises under
    ``jax.grad``; so does every kernel wrapper here, on the card and, for
    the same inputs, on the CPU where its plain twin stands in for it.
    ``inputs`` are tensors or tuples of tensors; anything else is ignored.
    """
    if not torch.is_grad_enabled():
        return
    flat = [t for a in inputs for t in (a if isinstance(a, (tuple, list)) else (a,))]
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the kernel has no backward (as "
            "the reference's pallas_call has none).  For gradients use "
            "heston_adi.greeks_ad or a scan route (heston_adi.solve / solve_batch, "
            "local_vol_pde.solve, local_vol_pde.solve_fused_batch(route='scan'), "
            "bs_pde.solve); or call under torch.no_grad() for values alone.")
