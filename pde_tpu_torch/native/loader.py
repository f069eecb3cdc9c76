"""Build and bind the repository's C++ host runtime (``src/cpp``) through
ctypes, at first use.

``g++`` compiles the unedited ``src/cpp/pde_host.cpp`` and
``src/cpp/pde_solvers.cpp`` with the JAX package's flags into
``build/pde_tpu_torch/``, keyed by a hash of the sources, the flags and
what ``-march=native`` resolves to on this host, so a tree copied to
another CPU builds its own library instead of loading one it cannot run.
The compiler writes a temporary file that ``os.replace`` then moves into
place, so processes that build at once never load a half-written library.
A missing compiler or a failed build raises :class:`NativeUnavailable`;
nothing falls back.  Only the functions a ported module calls are bound.
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

__all__ = ["NativeUnavailable", "SOURCES", "FLAGS", "library_path", "build", "load"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCES = (_ROOT / "src" / "cpp" / "pde_host.cpp", _ROOT / "src" / "cpp" / "pde_solvers.cpp")
BUILD_DIR = _ROOT / "build" / "pde_tpu_torch"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")
ABI_VERSION = 3   # pde_host_abi_version() of the sources this binds


class NativeUnavailable(RuntimeError):
    """The host library cannot be built or loaded."""


def _compiler() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeUnavailable("g++ not found: the host runtime of pde_tpu_torch is built "
                                "from src/cpp and needs a C++ compiler")
    return gxx


def _target(gxx: str) -> bytes:
    """The target options ``-march=native`` selects on this host's CPU."""
    proc = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, timeout=60)
    if proc.returncode != 0:
        raise NativeUnavailable(f"g++ cannot resolve -march=native:\n{proc.stderr.decode()}")
    return proc.stdout


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_target(_compiler()))
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpde_host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiling it first if it is not built yet."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_compiler(), *FLAGS, *map(str, SOURCES), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeUnavailable(f"g++ failed on {[s.name for s in SOURCES]}:\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with the bound functions' argument types."""
    lib = ctypes.CDLL(str(build()))
    lib.pde_host_abi_version.restype = ctypes.c_int32
    version = lib.pde_host_abi_version()
    if version != ABI_VERSION:
        raise NativeUnavailable(f"libpde_host ABI {version}, expected {ABI_VERSION}")
    dbl, i64 = ctypes.c_double, ctypes.c_int64
    dbl_p, i32_p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
    lib.hjb_march.argtypes = [dbl] * 7 + [i64, i64, dbl_p, dbl_p]
    lib.hjb_march.restype = None
    lib.hjb_march_bs.argtypes = [dbl] * 7 + [i64, i64, dbl_p, ctypes.c_int32, dbl_p]
    lib.hjb_march_bs.restype = None
    lib.hjb_march_bs_multi.argtypes = [dbl] * 7 + [i64, i64, i64, dbl_p, i32_p, dbl_p]
    lib.hjb_march_bs_multi.restype = None
    return lib
