"""Precision and device policy for pde_tpu_torch.

Two operating modes, as in the reference package:

* **parity** (float64/complex128): the CPU tests hold the port against
  ``pde_tpu`` under ``jax_enable_x64`` at the repo's 1e-8 price / 1e-6
  implied-vol gates.
* **speed** (float32/complex64): the GPU production path.

Library code never flips global torch flags (no ``set_default_dtype``): it
derives the working dtype from its tensor inputs via :func:`result_dtype`
and takes the device from them via :func:`device_of`.  Python scalars are
weakly typed, as in JAX: they never widen a tensor's dtype.
"""

from __future__ import annotations

import torch

__all__ = [
    "default_float",
    "complex_dtype_for",
    "result_dtype",
    "EPS",
    "device_of",
    "to_tensor",
    "where_flag",
]


def default_float() -> torch.dtype:
    """torch's default floating dtype (float32 unless the caller set it)."""
    return torch.get_default_dtype()


def complex_dtype_for(real_dtype: torch.dtype) -> torch.dtype:
    """Complex dtype matching a real dtype (f64 -> c128, else c64)."""
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def result_dtype(*args) -> torch.dtype:
    """Floating result dtype for a set of inputs (at least default float).

    Only tensors take part in the promotion; Python numbers are weak.
    """
    dt = default_float()
    for a in args:
        if isinstance(a, torch.Tensor):
            dt = torch.promote_types(dt, a.dtype)
    if not dt.is_floating_point:
        dt = default_float()
    return dt


def EPS(dtype: torch.dtype) -> float:
    """Machine epsilon for a dtype."""
    return float(torch.finfo(dtype).eps)


def device_of(*args, default="cpu") -> torch.device:
    """Device of the first tensor among ``args`` (``default`` if none)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device(default)


def to_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` (number, sequence, ndarray or tensor) as a tensor of ``dtype``
    on ``device``; a tensor already there is returned as it is."""
    return torch.as_tensor(x, dtype=dtype, device=device)


def where_flag(flag, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.where(flag, a, b)`` for a flag that is a Python bool or a
    bool/0-1 tensor (nonzero selects ``a``)."""
    if isinstance(flag, torch.Tensor):
        return torch.where(flag.to(device=a.device) != 0, a, b)
    return a if flag else b
