"""The C++ host runtime (twin of ``pde_tpu/native``, the HJB marches).

A lone HJB march is a serial chain a few hundred rows long: host-shaped
work, which ``src/cpp/pde_solvers.cpp`` runs in float64 on the CPU.  These
wrappers take and return numpy arrays; :mod:`.loader` builds the library
at first use and raises :class:`NativeUnavailable` when it cannot.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .loader import NativeUnavailable, build, load

__all__ = ["NativeUnavailable", "build", "load", "hjb_march", "hjb_march_bs",
           "hjb_march_bs_multi"]


def _c(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def hjb_march(theta, mu, sigma, r, T, x_min, x_max, exercise, n_time: int = 200) -> np.ndarray:
    """Float64 implicit-Euler obstacle march (``hjb._march``'s projection
    mode); the final value function on the x grid."""
    lib = load()
    exercise = np.ascontiguousarray(exercise, dtype=np.float64)
    out = np.zeros(len(exercise), dtype=np.float64)
    lib.hjb_march(theta, mu, sigma, r, T, x_min, x_max, len(exercise), n_time,
                  _c(exercise), _c(out))
    return out


def hjb_march_bs(theta, mu, sigma, r, T, x_min, x_max, exercise, reverse: bool,
                 n_time: int = 200) -> np.ndarray:
    """The exact LCP march by Brennan-Schwartz (``hjb._march(method=
    "brennan_schwartz")``), the contact region at the right end when
    ``reverse``."""
    lib = load()
    exercise = np.ascontiguousarray(exercise, dtype=np.float64)
    out = np.zeros(len(exercise), dtype=np.float64)
    lib.hjb_march_bs(theta, mu, sigma, r, T, x_min, x_max, len(exercise), n_time,
                     _c(exercise), int(bool(reverse)), _c(out))
    return out


def hjb_march_bs_multi(theta, mu, sigma, r, T, x_min, x_max, exercise, reverse,
                       n_time: int = 200) -> np.ndarray:
    """Every stopping problem of one config in one call, a thread a march:
    ``exercise`` (n_problems, n_space), ``reverse`` a flag a problem."""
    lib = load()
    exercise = np.ascontiguousarray(exercise, dtype=np.float64)
    n_problems, n = exercise.shape
    rev = np.ascontiguousarray(np.asarray(reverse, dtype=np.int32).reshape(n_problems))
    out = np.zeros((n_problems, n), dtype=np.float64)
    lib.hjb_march_bs_multi(theta, mu, sigma, r, T, x_min, x_max, n, n_time, n_problems,
                           _c(exercise), rev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                           _c(out))
    return out
