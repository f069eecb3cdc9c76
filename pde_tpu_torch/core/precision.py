"""Precision and device policy for pde_tpu_torch.

Two operating modes, as in the reference package:

* **parity** (float64/complex128): the CPU tests hold the port against
  ``pde_tpu`` under ``jax_enable_x64`` at the repo's 1e-8 price / 1e-6
  implied-vol gates.
* **speed** (float32/complex64): the GPU production path.

Library code never flips global torch flags (no ``set_default_dtype``): it
derives the working dtype from its tensor inputs via :func:`result_dtype`
and takes the device from them via :func:`device_of` (the card when no
input is a tensor).  Python scalars are weakly typed, as in JAX: they
never widen a tensor's dtype.

Entry points (calibrators, solvers, surface builders) run on the card
unless the caller asks for another device: ``device=None`` means
:func:`default_device`, which never picks the CPU quietly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "default_float",
    "complex_dtype_for",
    "result_dtype",
    "EPS",
    "default_device",
    "resolve_device",
    "device_of",
    "to_tensor",
    "host_tensor",
    "where_flag",
    "check_generator",
    "cholesky_nan",
    "blocked_cumsum",
    "blocked_cumprod",
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


def default_device() -> torch.device:
    """The first CUDA card, ``cuda:0``; raises when there is none.

    Entry points take this for ``device=None``: the CPU runs a port only
    when the caller passes ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pde_tpu_torch: no CUDA device (torch.cuda.is_available() is "
            "false); pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


def device_of(*args, default=None) -> torch.device:
    """Device of the first tensor among ``args``; with none,
    ``resolve_device(default)``: the card unless ``default`` names another
    device, so model functions called with plain numbers run on the card
    (or raise without one) rather than quietly on the CPU."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(default)


def to_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` (number, sequence, ndarray or tensor) as a tensor of ``dtype``
    on ``device``; a tensor already there is returned as it is."""
    return torch.as_tensor(x, dtype=dtype, device=device)


def host_tensor(x, device, dtype=None) -> torch.Tensor:
    """A host array ``x`` as a tensor on ``resolve_device(device)`` in one
    copy; ``dtype=None`` keeps the array's own floating precision (at least
    the default float, as :func:`result_dtype` reads inputs)."""
    t = torch.as_tensor(np.asarray(x))
    return t.to(device=resolve_device(device), dtype=dtype or result_dtype(t))


def where_flag(flag, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.where(flag, a, b)`` for a flag that is a Python bool or a
    bool/0-1 tensor (nonzero selects ``a``)."""
    if isinstance(flag, torch.Tensor):
        return torch.where(flag.to(device=a.device) != 0, a, b)
    return a if flag else b


def _card_index(d: torch.device):
    """The index of the card ``d`` names (a bare ``cuda``: the current one)."""
    return torch.cuda.current_device() if d.index is None else d.index


def check_generator(generator: torch.Generator, device) -> None:
    """Raise ``ValueError`` unless ``generator`` lives on ``device``: a draw
    never moves a path to another device."""
    gdev, device = torch.device(generator.device), torch.device(device)
    if gdev.type != device.type or (
            device.type == "cuda" and _card_index(gdev) != _card_index(device)):
        raise ValueError(f"the generator is on {gdev} but the path runs on {device}; "
                         f"pass a torch.Generator(device={str(device)!r})")


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``a`` (batched on leading axes), NaN below
    the diagonal and 0 above it where ``a`` is not positive definite in its
    dtype, as ``jnp.linalg.cholesky`` returns it: no error and no host
    read.  A jitter such as the reference's ``1e-12 I`` vanishes in
    float32, so a rho = 1 pair there takes this branch."""
    L, info = torch.linalg.cholesky_ex(a)
    failed = (info != 0)[..., None, None]
    return torch.where(failed, torch.full_like(L, math.nan).tril(), L)


# XLA's CPU backend rewrites a cumulative sum or product into blocks of 16:
# sequential within a block, the blocks' running totals scanned the same
# way, recursively.  ``jnp.cumsum``/``jnp.cumprod`` round in that order.
_SCAN_BLOCK = 16


def _sequential(x: torch.Tensor, op) -> torch.Tensor:
    """Prefix ``op`` over the last axis, left to right, one column at a time."""
    if x.shape[-1] == 0:
        return x
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(op(cols[-1], x[..., j]))
    return torch.stack(cols, -1)


def _blocked_scan(x: torch.Tensor, op, identity: float) -> torch.Tensor:
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential(x, op)
    m = -(-n // _SCAN_BLOCK)
    lead = x.shape[:-1]
    rows = torch.nn.functional.pad(x, (0, m * _SCAN_BLOCK - n), value=identity)
    rows = _sequential(rows.reshape(*lead, m, _SCAN_BLOCK), op)
    totals = _blocked_scan(rows[..., -1], op, identity)
    before = torch.nn.functional.pad(totals[..., :-1], (1, 0), value=identity)
    return op(rows, before[..., None]).reshape(*lead, m * _SCAN_BLOCK)[..., :n]


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums over the last axis, rounded as the reference's compiled
    ``jnp.cumsum`` rounds them on the CPU (blocks of 16, sequential within
    a block, the block totals scanned likewise).  Elementwise adds only, so
    the card and the CPU give the same bits, in ceil(log16 n) levels of at
    most 16 launches each."""
    return _blocked_scan(x, torch.add, 0.0)


def blocked_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Prefix products over the last axis in :func:`blocked_cumsum`'s order
    (``jnp.cumprod``'s on the CPU)."""
    return _blocked_scan(x, torch.mul, 1.0)
