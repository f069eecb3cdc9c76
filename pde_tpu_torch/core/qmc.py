"""Quasi-Monte Carlo: Sobol' points generated with XOR bit-scans (twin of
``pde_tpu/core/qmc.py``).

Direction numbers are a small host-side table (``(dim, 32)`` uint32 from
scipy's Joe-Kuo data, fetched once per dimension and cached).  Everything
else is integer tensor work on the points' device:

* **point generation**: ``x_i = XOR of V[:, k] over the set bits k of
  gray(i)``, a loop of 32 masked XORs over the whole ``(n_points, dim)``
  block, with no recurrence over points;
* **randomization**: Matousek linear matrix scrambling (a random unit
  lower-triangular bit matrix per dimension applied to the direction
  numbers, its GF(2) inner products taken as XOR-folded parities) and a
  digital shift.  Both keep the digital net, so every randomization keeps
  the QMC rate while making the estimator unbiased.

Words are held in ``int64`` tensors, masked to their low 32 bits: torch's
``uint32`` has no shifts on the CPU.  Each randomized function has a public
form that draws its words from a ``torch.Generator`` (where the reference
takes a PRNG key) and a private one that takes the words themselves: the
LMS rows ``(dim, 32)`` and the shift ``(dim,)``.

Points map to (0, 1) at the centre of their 2^-24 (float32) / 2^-32
(float64) cell, so ``ndtri`` never sees 0 or 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .precision import check_generator, default_float, device_of

__all__ = [
    "HAVE_DIRECTION_NUMBERS",
    "sobol_direction_numbers",
    "scramble_direction_numbers",
    "sobol_uint32",
    "sobol_uint32_from_gray",
    "gray_codes",
    "to_unit",
    "sobol_uniform",
    "sobol_normal",
]

_NBITS = 32
_MASK = 0xFFFFFFFF

try:  # direction-number source: scipy's Joe-Kuo table (host-side, once)
    from scipy.stats import qmc as _scipy_qmc

    HAVE_DIRECTION_NUMBERS = True
except ImportError:  # pragma: no cover - scipy is in the base image
    _scipy_qmc = None
    HAVE_DIRECTION_NUMBERS = False


@functools.lru_cache(maxsize=None)
def _direction_numbers_cached(dim: int):
    sob = _scipy_qmc.Sobol(d=dim, scramble=False, bits=_NBITS)
    return np.ascontiguousarray(np.asarray(sob._sv, dtype=np.uint32))


def sobol_direction_numbers(dim: int) -> np.ndarray:
    """Host-side ``(dim, 32)`` uint32 Sobol' direction numbers (MSB-first):
    the i-th point is the XOR over the set bits k of gray(i) of
    ``V[:, k]``, mapped to (0, 1) as ``x * 2**-32`` (scipy's own layout)."""
    if not HAVE_DIRECTION_NUMBERS:  # pragma: no cover
        raise RuntimeError(
            "Sobol direction numbers need scipy.stats.qmc; scipy is "
            "unavailable in this environment"
        )
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")
    return _direction_numbers_cached(int(dim))


def _as_words(x, device) -> torch.Tensor:
    """uint32 words (numpy array, sequence or tensor) as int64 on ``device``."""
    if isinstance(x, np.ndarray):
        x = x.astype(np.int64)
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def _words(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform 32-bit words of ``shape`` from ``generator`` on ``device``."""
    check_generator(generator, device)
    return torch.randint(0, 1 << _NBITS, shape, generator=generator, dtype=torch.int64,
                         device=device)


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Parity of each 32-bit word (1 for an odd number of set bits)."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def _scramble_direction_numbers(dv, rows: torch.Tensor) -> torch.Tensor:
    """Matousek LMS of ``dv`` by the random words ``rows`` ``(dim, 32)``:
    row ``i`` keeps its bits strictly above the diagonal position ``31 - i``
    (columns 0..i-1, MSB-first) and sets the diagonal; output digit ``i`` of
    every direction number is the GF(2) inner product of that row with the
    input's digits."""
    dv = _as_words(dv, rows.device)
    i = torch.arange(_NBITS, dtype=torch.int64, device=rows.device)
    diag = 1 << (31 - i)
    above = ((1 << i) - 1) << (_NBITS - i)  # i == 0: no bits above
    m = (rows & above) | diag  # (dim, 32) row masks
    par = _parity(m[:, :, None] & dv[:, None, :])  # (dim, row i, column k)
    # row i writes bit (31 - i); the rows hit disjoint bits, so a sum
    # assembles the word without carries
    return torch.sum(par << (31 - i)[None, :, None], dim=1)


def scramble_direction_numbers(dv, generator: torch.Generator, *, device=None):
    """Matousek linear-matrix scramble of a ``(dim, 32)`` direction-number
    block, its random rows drawn from ``generator`` on the block's device
    (``dv``'s when a tensor, else ``device``, else the card), which must be
    the generator's.  Combine with a digital shift (:func:`sobol_uint32`)
    for unbiased randomized QMC.  Returns int64 words."""
    device = device_of(dv, default=device)
    rows = _words(generator, (np.shape(dv)[0], _NBITS), device)
    return _scramble_direction_numbers(dv, rows)


def sobol_uint32_from_gray(g: torch.Tensor, dv, shift=None) -> torch.Tensor:
    """Sobol words for precomputed Gray codes ``g`` ``(n,)``: ``dv`` ``(dim,
    32)``, ``shift`` an optional ``(dim,)`` digital shift; returns ``(n,
    dim)`` int64 words.  32 masked-XOR passes over the whole block, one per
    bit position of the Gray code; time-stepping simulations hoist the Gray
    codes and feed each step its slice of ``dv``."""
    dv = _as_words(dv, g.device)
    x = torch.zeros((g.shape[0], dv.shape[0]), dtype=torch.int64, device=g.device)
    for k in range(_NBITS):
        take = -((g >> k) & 1)  # all ones where bit k is set, else 0
        x = x ^ (take[:, None] & dv[None, :, k])
    if shift is not None:
        x = x ^ _as_words(shift, g.device)[None, :]
    return x


def gray_codes(n: int, index_offset=0, *, device=None) -> torch.Tensor:
    """``(n,)`` Gray codes of the point indices from ``index_offset`` (32-bit
    wrap-around, as the reference's uint32 arithmetic), on ``device`` (the
    card by default)."""
    device = device_of(index_offset, default=device)
    i = (torch.arange(n, dtype=torch.int64, device=device) + index_offset) & _MASK
    return i ^ (i >> 1)


def _sobol_uint32(dv, n: int, shift, index_offset, device) -> torch.Tensor:
    return sobol_uint32_from_gray(gray_codes(n, index_offset, device=device), dv, shift)


def sobol_uint32(dv, n: int, generator: torch.Generator | None = None, *, index_offset=0,
                 device=None) -> torch.Tensor:
    """``(n, dim)`` Sobol words on ``dv``'s device (``device``, else the card,
    for a host table); ``generator`` adds a digital shift of one uniform
    word per dimension drawn from it.  Combine with
    :func:`scramble_direction_numbers` for full Matousek LMS + shift."""
    device = device_of(dv, default=device)
    shift = None if generator is None else _words(generator, (np.shape(dv)[0],), device)
    return _sobol_uint32(dv, n, shift, index_offset, device)


def to_unit(x: torch.Tensor, dtype) -> torch.Tensor:
    """Words to the centre of their cell in (0, 1): 2^-32 cells in float64;
    in another dtype the top 24 bits, in that dtype's arithmetic as the
    reference."""
    if dtype == torch.float64:
        return x.to(torch.float64) * 2.0**-32 + 2.0**-33
    return (x >> 8).to(dtype) * 2.0**-24 + 2.0**-25


def sobol_uniform(dv, n: int, generator: torch.Generator | None = None, *, index_offset=0,
                  dtype=None, device=None) -> torch.Tensor:
    """``(n, dim)`` Sobol points in the open interval (0, 1)."""
    dtype = default_float() if dtype is None else dtype
    return to_unit(sobol_uint32(dv, n, generator, index_offset=index_offset, device=device),
                   dtype)


def sobol_normal(dv, n: int, generator: torch.Generator | None = None, *, index_offset=0,
                 dtype=None, device=None) -> torch.Tensor:
    """``(n, dim)`` standard-normal Sobol points by the inverse CDF."""
    return torch.special.ndtri(sobol_uniform(dv, n, generator, index_offset=index_offset,
                                             dtype=dtype, device=device))
