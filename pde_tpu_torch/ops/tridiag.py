"""Batched tridiagonal solvers (twin of ``pde_tpu/ops/tridiag.py``).

* :func:`thomas` — the Thomas recurrence along the last axis, a Python
  loop over the system axis with every step vectorised over the batch.
  Works on any device and dtype (float64 parity mode) and is
  differentiable by autograd.
* :func:`thomas_factor` / :func:`thomas_solve_factored` — the elimination
  of a time-independent matrix done once, then multiply-only solves.
* :func:`pcr` — parallel cyclic reduction for few, very long systems:
  ceil(log2 n) rounds of shifted whole-tensor eliminations.

:func:`tridiagonal_solve` keeps the reference's dispatch rule.  Its
kernel branch (2D float32 batches on the accelerator, the reference's
``thomas_pallas``) is not ported yet and raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["thomas", "thomas_factor", "thomas_solve_factored", "ThomasFactors",
           "pcr", "tridiagonal_solve"]


class ThomasFactors(NamedTuple):
    """Forward-elimination state of a time-INDEPENDENT system: per-step
    :func:`thomas_solve_factored` is then multiply/FMA-only in the serial
    dimension."""

    cp: torch.Tensor     # (..., n) super-diag multipliers; cp[..., n-1] = 0
    inv_m: torch.Tensor  # (..., n) reciprocal pivots
    lo: torch.Tensor     # (..., n) row-aligned sub-diagonal; lo[..., 0] = 0


def _bands(lower, diag, upper, rhs=None):
    """Row-aligned (lo, d, up[, b]) broadcast to the common batch shape:
    ``lo[..., 0] = 0`` and ``up[..., n-1] = 0``."""
    ts = [torch.as_tensor(a) for a in (lower, diag, upper)]
    if rhs is not None:
        ts.append(torch.as_tensor(rhs))
    n = ts[1].shape[-1]
    batch = torch.broadcast_shapes(*(t.shape[:-1] for t in ts))
    zeros = torch.zeros(batch + (1,), dtype=ts[1].dtype, device=ts[1].device)
    lo = torch.cat([zeros, ts[0].expand(batch + (n - 1,))], -1)
    up = torch.cat([ts[2].expand(batch + (n - 1,)), zeros], -1)
    rest = [t.expand(batch + (n,)) for t in ts[1:2] + ts[3:]]
    return (lo, rest[0], up, *rest[1:])


def thomas_factor(lower, diag, upper) -> ThomasFactors:
    """Forward-eliminate the matrix only (shapes as :func:`thomas`)."""
    lo, d, up = _bands(lower, diag, upper)
    n = d.shape[-1]
    cp = torch.empty_like(d)
    inv_m = torch.empty_like(d)
    cp[..., 0] = up[..., 0] / d[..., 0]
    inv_m[..., 0] = 1.0 / d[..., 0]
    for i in range(1, n):
        inv = 1.0 / (d[..., i] - lo[..., i] * cp[..., i - 1])
        cp[..., i] = up[..., i] * inv
        inv_m[..., i] = inv
    return ThomasFactors(cp, inv_m, lo)


def thomas_solve_factored(factors: ThomasFactors, rhs) -> torch.Tensor:
    """Solve with precomputed factors; only FMA/multiply in the serial chain."""
    cp, inv_m, lo = factors
    rhs = torch.as_tensor(rhs)
    n = cp.shape[-1]
    batch = torch.broadcast_shapes(cp.shape[:-1], rhs.shape[:-1])
    b, cp, inv_m, lo = (a.expand(batch + (n,)) for a in (rhs, cp, inv_m, lo))
    dp = torch.empty(batch + (n,), dtype=b.dtype, device=b.device)
    dp[..., 0] = b[..., 0] * inv_m[..., 0]
    for i in range(1, n):
        dp[..., i] = (b[..., i] - lo[..., i] * dp[..., i - 1]) * inv_m[..., i]
    return _back_substitute(cp, dp)


def _back_substitute(cp, dp):
    x = torch.empty_like(dp)
    n = dp.shape[-1]
    x[..., n - 1] = dp[..., n - 1]
    for i in range(n - 2, -1, -1):
        x[..., i] = dp[..., i] - cp[..., i] * x[..., i + 1]
    return x


def thomas(lower, diag, upper, rhs) -> torch.Tensor:
    """Solve tridiagonal systems along the last axis.

    Shapes (broadcast-compatible leading batch dims allowed):
      lower: (..., n-1)   sub-diagonal (A[i, i-1] = lower[i-1])
      diag:  (..., n)     main diagonal
      upper: (..., n-1)   super-diagonal (A[i, i+1] = upper[i])
      rhs:   (..., n)

    The loop runs over the system axis; every step is one vectorised op
    over the batch, with a true divide at each pivot.
    """
    lo, d, up, b = _bands(lower, diag, upper, rhs)
    n = d.shape[-1]
    cp = torch.empty_like(b)
    dp = torch.empty_like(b)
    cp[..., 0] = up[..., 0] / d[..., 0]
    dp[..., 0] = b[..., 0] / d[..., 0]
    for i in range(1, n):
        m = d[..., i] - lo[..., i] * cp[..., i - 1]
        cp[..., i] = up[..., i] / m
        dp[..., i] = (b[..., i] - lo[..., i] * dp[..., i - 1]) / m
    return _back_substitute(cp, dp)


def pcr(lower, diag, upper, rhs) -> torch.Tensor:
    """Parallel cyclic reduction along the last axis — for LONG systems.

    ceil(log2 n) rounds, each eliminating the neighbours at stride 1, 2,
    4, ... in whole-tensor ops; then every equation is decoupled and
    x = d / b.  Same shapes as :func:`thomas`; needs diagonal dominance
    (which the CN/ADI/implicit-obstacle systems have).
    """
    a, b, c, d = _bands(lower, diag, upper, rhs)
    n = b.shape[-1]

    def shift_down(x, s):  # value of row i-s, zero beyond the edge
        return torch.cat([torch.zeros_like(x[..., :s]), x[..., :-s]], -1)

    def shift_up(x, s):  # value of row i+s
        return torch.cat([x[..., s:], torch.zeros_like(x[..., :s])], -1)

    s = 1
    for _ in range(max(1, math.ceil(math.log2(n)))):
        # out-of-range neighbours are the identity equation (b=1, a=c=d=0)
        ones = torch.ones_like(b)
        b_dn = torch.where(shift_down(ones, s) > 0, shift_down(b, s), ones)
        b_up = torch.where(shift_up(ones, s) > 0, shift_up(b, s), ones)
        alpha = -a / b_dn
        gamma = -c / b_up
        b, d, a, c = (b + alpha * shift_down(c, s) + gamma * shift_up(a, s),
                      d + alpha * shift_down(d, s) + gamma * shift_up(d, s),
                      alpha * shift_down(a, s),
                      gamma * shift_up(c, s))
        if s < n:
            s *= 2
    return d / b


def tridiagonal_solve(lower, diag, upper, rhs, use_kernel: bool | None = None):
    """Dispatch on the batch/length regime, as the reference does.

    - Few, very long systems -> :func:`pcr`.
    - Wide float32 2D batches on the card -> the batched Thomas kernel
      (the reference's ``thomas_pallas``): not ported yet, raises.
    - Everything else -> :func:`thomas`.
    """
    rhs = torch.as_tensor(rhs)
    n = rhs.shape[-1]
    batch_size = math.prod(rhs.shape[:-1]) if rhs.dim() > 1 else 1
    if use_kernel is None and n >= 8192 and batch_size <= 16:
        return pcr(lower, diag, upper, rhs)
    if use_kernel is None:
        use_kernel = (rhs.dim() == 2 and rhs.dtype == torch.float32
                      and rhs.device.type == "cuda")
    if use_kernel:
        raise NotImplementedError("K5 thomas_pallas not ported yet")
    return thomas(lower, diag, upper, rhs)
