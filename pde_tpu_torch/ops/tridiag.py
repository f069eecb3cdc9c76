"""Batched tridiagonal solvers (twin of ``pde_tpu/ops/tridiag.py``).

* :func:`thomas` — the Thomas recurrence along the last axis, a Python
  loop over the system axis with every step vectorised over the batch.
  Works on any device and dtype (float64 parity mode) and is
  differentiable by autograd: each row's result is a new tensor, collected
  and stacked at the end, never written into a tensor that is read later.
* :func:`thomas_factor` / :func:`thomas_solve_factored` — the elimination
  of a time-independent matrix done once, then multiply-only solves.
* :func:`thomas_batched` — B independent systems forward-eliminated and
  back-substituted in ONE launch of the CUDA kernel ``csrc/thomas_batched.cu``
  (the reference's ``thomas_pallas``) on a CUDA tensor, its plain twin
  :func:`_thomas_batched_plain` on a CPU tensor.  The kernel has no
  backward: under autograd it raises, as ``pallas_call`` does under
  ``jax.grad``.
* :func:`pcr` — parallel cyclic reduction for few, very long systems:
  ceil(log2 n) rounds of shifted whole-tensor eliminations.

:func:`tridiagonal_solve` keeps the reference's dispatch rule: its kernel
branch takes 2D float32 batches on the card to :func:`thomas_batched`,
unless autograd runs through them (:func:`kernel_route`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .build import load_library, refuse_autograd

__all__ = ["thomas", "thomas_factor", "thomas_solve_factored", "ThomasFactors",
           "thomas_batched", "pcr", "tridiagonal_solve", "kernel_route"]

_SOURCE = "thomas_batched.cu"
_LANE_THREADS = 128   # threads of a lane-group block (csrc kLaneThreads)
_SMEM_MAX = 232448    # bytes of shared memory one block can have (227 KB)


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
    c = up[..., 0] / d[..., 0]
    cps, invs = [c], [1.0 / d[..., 0]]
    for i in range(1, n):
        inv = 1.0 / (d[..., i] - lo[..., i] * c)
        c = up[..., i] * inv
        cps.append(c)
        invs.append(inv)
    return ThomasFactors(torch.stack(cps, -1), torch.stack(invs, -1), lo)


def thomas_solve_factored(factors: ThomasFactors, rhs) -> torch.Tensor:
    """Solve with precomputed factors; only FMA/multiply in the serial chain."""
    cp, inv_m, lo = factors
    rhs = torch.as_tensor(rhs)
    n = cp.shape[-1]
    batch = torch.broadcast_shapes(cp.shape[:-1], rhs.shape[:-1])
    b, cp, inv_m, lo = (a.expand(batch + (n,)) for a in (rhs, cp, inv_m, lo))
    dp = b[..., 0] * inv_m[..., 0]
    dps = [dp]
    for i in range(1, n):
        dp = (b[..., i] - lo[..., i] * dp) * inv_m[..., i]
        dps.append(dp)
    return _back_substitute(cp.unbind(-1), dps)


def _back_substitute(cps, dps):
    """x[n-1] = dp[n-1], x[i] = dp[i] - cp[i] x[i+1], from the columns of
    the forward sweep; stacked along the last axis."""
    n = len(dps)
    x = dps[n - 1]
    xs = [x]
    for i in range(n - 2, -1, -1):
        x = dps[i] - cps[i] * x
        xs.append(x)
    return torch.stack(xs[::-1], -1)


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
    c = up[..., 0] / d[..., 0]
    dp = b[..., 0] / d[..., 0]
    cps, dps = [c], [dp]
    for i in range(1, n):
        m = d[..., i] - lo[..., i] * c
        dp = (b[..., i] - lo[..., i] * dp) / m
        c = up[..., i] / m
        cps.append(c)
        dps.append(dp)
    return _back_substitute(cps, dps)


def thomas_batched(lower, diag, upper, rhs) -> torch.Tensor:
    """B independent n-point systems in one kernel (the reference's
    ``thomas_pallas``, ``pde_tpu/ops/tridiag.py:182``).

    Shapes: lower (B, n-1), diag (B, n), upper (B, n-1), rhs (B, n) ->
    (B, n), float32.  Forward elimination takes one reciprocal per pivot
    and multiplies (``inv_m = 1/m; c = up inv_m; dp = (b - lo dp) inv_m``),
    row 0 divides; the back substitution follows in the same launch.  On
    a CUDA tensor it launches ``csrc/thomas_batched.cu`` or raises: a group
    of lanes per system reading the operands where they lie (any batch
    stride, 0 for a band shared by every system; :func:`_lane_plan`), or,
    for systems too long for a block's shared memory, the first design, one
    thread per system on batch-last copies.  On a CPU tensor it runs
    :func:`_thomas_batched_plain`.  Under autograd it raises (no backward).
    ``launches`` counts the kernel's launches of either design,
    ``launches_smem`` those of the lane-group design.
    """
    refuse_autograd("thomas_batched", lower, diag, upper, rhs)
    B, n = rhs.shape
    for a, shape in ((lower, (B, n - 1)), (diag, (B, n)), (upper, (B, n - 1)),
                     (rhs, (B, n))):
        if tuple(a.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(a.shape)}")
        if a.dtype != torch.float32 or a.device != rhs.device:
            raise ValueError("all inputs must be float32 on one device")
    if n < 2:
        raise ValueError("systems need n >= 2")
    if rhs.device.type == "cuda":
        return _launch_thomas(lower, diag, upper, rhs)
    if rhs.device.type == "cpu":
        return _thomas_batched_plain(lower, diag, upper, rhs)
    raise ValueError(f"no batched Thomas solve for device {rhs.device}")


thomas_batched.launches = 0
thomas_batched.launches_smem = 0


def _row_major(lower, diag, upper, rhs):
    """Batch-last, row-aligned (n, B) operands: lo[0] = 0, up[n-1] = 0
    (the twin's and the first design's layout)."""
    zero = torch.zeros_like(rhs[:, :1])
    lo = torch.cat([zero, lower], 1).T.contiguous()
    up = torch.cat([upper, zero], 1).T.contiguous()
    return lo, diag.T.contiguous(), up, rhs.T.contiguous()


@functools.lru_cache(maxsize=None)
def _lane_plan(n: int):
    """The lane-group route's layout for n-point systems: ``(g, ch, cp,
    n_bytes)`` — lanes per system (a power of two up to 32, so that a
    lane's chunk holds about four rows), rows per chunk, the padded chunk
    stride in shared memory (odd, so the lanes of a warp hit distinct
    banks) and the block's bytes (four operands of its 128 / g systems) —
    or None when that exceeds what a block can have.  Cached per n."""
    g = 1
    while g < 32 and 4 * g < n:
        g *= 2
    ch = -(-n // g)
    cp = ch | 1
    n_bytes = 4 * 4 * (_LANE_THREADS // g) * g * cp
    return (g, ch, cp, n_bytes) if n_bytes <= _SMEM_MAX else None


@functools.lru_cache(maxsize=None)
def _thomas_library():
    """The first design's launcher (batch-last operands)."""
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_thomas_batched
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _lanes_library():
    """The lane-group route's launcher (the public (B, n) layout)."""
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_thomas_lanes
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_thomas(lower, diag, upper, rhs):
    """One launch on the current stream, on the route :func:`_lane_plan`
    picks from n."""
    plan = _lane_plan(rhs.shape[1])
    if plan is None:
        return _launch_thomas_first(lower, diag, upper, rhs)
    return _launch_thomas_lanes(lower, diag, upper, rhs, plan)


def _batch_stride(a):
    """``a`` with contiguous rows, and the floats between its rows (0 for
    one row or a band expanded over the batch)."""
    if a.shape[1] > 1 and a.stride(1) != 1:
        a = a.contiguous()
    return a, (a.stride(0) if a.shape[0] > 1 else 0)


def _launch_thomas_lanes(lower, diag, upper, rhs, plan):
    """The lane-group route: reads the operands where they lie, writes a
    fresh (B, n) result."""
    B, n = rhs.shape
    g, ch, cp, n_bytes = plan
    ops = [_batch_stride(a) for a in (lower, diag, upper, rhs)]
    out = torch.empty((B, n), dtype=torch.float32, device=rhs.device)
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    err = _lanes_library()(*(a.data_ptr() for a, _ in ops), out.data_ptr(),
                           *(s for _, s in ops), B, n, g, ch, cp, n_bytes, stream)
    if err != 0:
        raise RuntimeError(f"batched Thomas launch failed: CUDA error {err}")
    thomas_batched.launches += 1
    thomas_batched.launches_smem += 1
    return out


def _launch_thomas_first(lower, diag, upper, rhs):
    """The first design, for systems too long for the lane-group route:
    batch-last copies, one thread per system."""
    B, n = rhs.shape
    ins = _row_major(lower, diag, upper, rhs)
    out, C = (torch.empty((n, B), dtype=torch.float32, device=rhs.device)
              for _ in range(2))
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    err = _thomas_library()(*(t.data_ptr() for t in (*ins, out, C)), B, n, stream)
    if err != 0:
        raise RuntimeError(f"batched Thomas launch failed: CUDA error {err}")
    thomas_batched.launches += 1
    return out.T


def _thomas_batched_plain(lower, diag, upper, rhs):
    """The kernel's recurrence in tensor ops over the batch, rows in a
    Python loop: a reciprocal per pivot (row 0 divides), as the kernel."""
    lo, d, up, b = _row_major(lower, diag, upper, rhs)
    n = d.shape[0]
    c = up[0] / d[0]
    dp = b[0] / d[0]
    cps, dps = [c], [dp]
    for i in range(1, n):
        inv_m = 1.0 / (d[i] - lo[i] * c)
        c = up[i] * inv_m
        dp = (b[i] - lo[i] * dp) * inv_m
        cps.append(c)
        dps.append(dp)
    return _back_substitute(cps, dps)


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


def kernel_route(*tensors) -> bool:
    """Whether a solve on these tensors belongs to the kernel: float32 on
    a CUDA device, with no autograd through it (the kernels have no
    backward).  The scan solvers ask this before they hand a sweep to
    :func:`tridiagonal_solve` instead of their factored twin, and
    :func:`tridiagonal_solve` asks it for its automatic choice."""
    t = tensors[0]
    if t.device.type != "cuda" or t.dtype != torch.float32:
        return False
    return not (torch.is_grad_enabled() and any(a.requires_grad for a in tensors))


def tridiagonal_solve(lower, diag, upper, rhs, use_kernel: bool | None = None):
    """Dispatch on the batch/length regime, as the reference does.

    - Few, very long systems -> :func:`pcr`.
    - Wide float32 2D batches on the card, outside autograd
      (:func:`kernel_route`) -> :func:`thomas_batched` (K5).  Shared 1-D
      bands are expanded over the batch, which copies nothing.
    - Everything else -> :func:`thomas`, which autograd differentiates.
    ``use_kernel=True`` takes the kernel branch whatever the tensors are:
    under autograd :func:`thomas_batched` then raises.
    """
    rhs = torch.as_tensor(rhs)
    n = rhs.shape[-1]
    batch_size = math.prod(rhs.shape[:-1]) if rhs.dim() > 1 else 1
    if use_kernel is None and n >= 8192 and batch_size <= 16:
        return pcr(lower, diag, upper, rhs)
    if use_kernel is None:
        use_kernel = rhs.dim() == 2 and kernel_route(
            rhs, *(torch.as_tensor(b) for b in (lower, diag, upper)))
    if use_kernel:
        lower, diag, upper = (torch.as_tensor(b).expand(rhs.shape[:-1] + (m,))
                              for b, m in ((lower, n - 1), (diag, n), (upper, n - 1)))
        return thomas_batched(lower, diag, upper, rhs)
    return thomas(lower, diag, upper, rhs)
