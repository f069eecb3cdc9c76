"""Linear-complementarity (obstacle) solvers (twin of
``pde_tpu/solvers/lcp.py``): for tridiagonal A,

    A x >= b,   x >= g,   (x - g)^T (A x - b) = 0.

* :func:`projected_sor` — red-black projected SOR: for a tridiagonal
  operator the even rows depend only on odd neighbours and vice versa, so
  each half-sweep is one vectorised update over all rows.  A fixed
  iteration count; the complementarity residual is returned.  On float32
  tensors on the card, outside autograd, the sweeps run in ONE launch of
  :func:`projected_sor_batched`.
* :func:`projected_sor_batched` — all ``n_iter`` sweeps for a batch of
  systems in one launch of the CUDA kernel ``csrc/psor_batched.cu`` (the
  reference's ``projected_sor_pallas``) on a CUDA tensor: one warp per
  system, its rows and operands in registers, the residual computed in the
  kernel (:func:`_warp_plan`; systems longer than 256 rows take the first
  design, one block per system); on a CPU tensor its plain twin,
  :func:`projected_sor` itself.
* :func:`brennan_schwartz` (with :func:`brennan_schwartz_factor` /
  :func:`brennan_schwartz_apply`) — the EXACT solve in one projected pass
  when the contact region is one-sided.

Port notes: the reference's lane padding of the PSOR kernel's batch and its
``block_b``/``interpret`` arguments (TPU artifacts) have no counterpart;
the kernel takes an optional start ``x0``, which the reference's kernel
does not, so that ``projected_sor(..., x0=V)`` on the card goes through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.build import load_library, refuse_autograd
from ..ops.tridiag import _batch_stride, kernel_route

__all__ = ["brennan_schwartz", "brennan_schwartz_factor",
           "brennan_schwartz_apply", "BrennanSchwartzFactors",
           "projected_sor", "projected_sor_batched", "psor_step"]

_SOURCE = "psor_batched.cu"
_MAX_CH = 8     # rows a lane of the warp route can hold (csrc kMaxCh)


def _apply_tridiag(lower, diag, upper, x):
    """A x for tridiagonal A (lower/upper length n-1)."""
    zero = torch.zeros_like(x[..., :1])
    out = diag * x + torch.cat([zero, lower * x[..., :-1]], -1)
    return out + torch.cat([upper * x[..., 1:], zero], -1)


def psor_step(lower, diag, upper, b, g, x, omega, red_mask, black_mask):
    """One red-black projected SOR sweep (two vectorised half-updates)."""

    def half(x, mask):
        # Gauss-Seidel update for every row at once; ``mask`` selects the
        # colour that commits.  Rows of one colour read only the other
        # colour's entries, so the parallel update is exact Gauss-Seidel.
        zero = torch.zeros_like(x[..., :1])
        neighbor = torch.cat([zero, lower * x[..., :-1]], -1)
        neighbor = neighbor + torch.cat([upper * x[..., 1:], zero], -1)
        gs = (b - neighbor) / diag
        x_new = x + omega * (gs - x)
        x_new = torch.maximum(x_new, g)  # projection onto the obstacle
        return torch.where(mask, x_new, x)

    x = half(x, red_mask)
    return half(x, black_mask)


def _residual(lower, diag, upper, b, g, x):
    """max |min(A x - b, x - g)|: the LCP complementarity residual."""
    return torch.max(torch.abs(torch.minimum(_apply_tridiag(lower, diag, upper, x) - b,
                                             x - g)))


def projected_sor(lower, diag, upper, b, g, x0=None, omega: float = 1.5,
                  n_iter: int = 60):
    """Solve the tridiagonal LCP with ``n_iter`` red-black PSOR sweeps.

    Shapes: lower/upper (..., n-1), diag/b/g/x0 (..., n); broadcasts over
    leading batch dims.  Returns (x, residual), residual = max |min(A x - b,
    x - g)| (0 at the exact solution).  Float32 tensors on a CUDA device,
    with no autograd through them, run as one launch of
    :func:`projected_sor_batched`.
    """
    lower, diag, upper, b, g = (torch.as_tensor(a) for a in (lower, diag, upper, b, g))
    if kernel_route(b, lower, diag, upper, g, *(() if x0 is None else (x0,))):
        n = diag.shape[-1]
        batch = torch.broadcast_shapes(lower.shape[:-1], diag.shape[:-1],
                                       upper.shape[:-1], b.shape[:-1], g.shape[:-1],
                                       *(() if x0 is None else (x0.shape[:-1],)))
        flat = lambda a, m: a.expand(batch + (m,)).reshape(-1, m)  # noqa: E731
        x, resid = projected_sor_batched(
            flat(lower, n - 1), flat(diag, n), flat(upper, n - 1), flat(b, n),
            flat(g, n), omega=omega, n_iter=n_iter,
            x0=None if x0 is None else flat(x0, n))
        return x.reshape(batch + (n,)), resid
    return _projected_sor(lower, diag, upper, b, g, x0, omega, n_iter)


def _projected_sor(lower, diag, upper, b, g, x0, omega, n_iter):
    """The sweeps in tensor ops, one Python iteration a sweep."""
    n = diag.shape[-1]
    x = torch.maximum(b / diag, g) if x0 is None else torch.maximum(torch.as_tensor(x0), g)
    red = torch.arange(n, device=diag.device) % 2 == 0
    black = ~red
    for _ in range(n_iter):
        x = psor_step(lower, diag, upper, b, g, x, omega, red, black)
    return x, _residual(lower, diag, upper, b, g, x)


def projected_sor_batched(lower, diag, upper, b, g, omega: float = 1.5,
                          n_iter: int = 60, x0=None):
    """All ``n_iter`` red-black PSOR sweeps for B systems in one kernel
    (the reference's ``projected_sor_pallas``, ``pde_tpu/solvers/lcp.py:251``).

    Shapes: lower/upper (B, n-1), diag/b/g (and ``x0``) (B, n), float32.
    Same LCP and semantics as :func:`projected_sor`; the start is
    max(b / diag, g), or max(x0, g) when ``x0`` is given.  Returns
    (x, residual).  On a CUDA tensor it launches ``csrc/psor_batched.cu``
    or raises: for n <= 256 the warp route (one warp per system, the
    operands read where they lie, each system's residual computed in the
    kernel: one launch, and one reduction more when B > 1), else the first
    design (one thread block per system on padded bands, the residual in
    PyTorch).  On a CPU tensor it runs the plain twin, the tensor-op sweeps
    of :func:`projected_sor` in float32.  ``launches`` counts the kernel's
    launches of either design, ``launches_warp`` those of the warp route.
    """
    refuse_autograd("projected_sor_batched", lower, diag, upper, b, g, x0)
    B, n = b.shape
    ins = [lower, diag, upper, b, g] + ([] if x0 is None else [x0])
    shapes = [(B, n - 1), (B, n), (B, n - 1), (B, n), (B, n), (B, n)]
    for a, shape in zip(ins, shapes):
        if tuple(a.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(a.shape)}")
        if a.dtype != torch.float32 or a.device != b.device:
            raise ValueError("all inputs must be float32 on one device")
    if n < 2 or n_iter < 0:
        raise ValueError("systems need n >= 2 and n_iter >= 0")
    if b.device.type == "cuda":
        return _launch_psor(lower, diag, upper, b, g, x0, omega, n_iter)
    if b.device.type == "cpu":
        return _projected_sor(lower, diag, upper, b, g, x0, omega, n_iter)
    raise ValueError(f"no batched PSOR for device {b.device}")


projected_sor_batched.launches = 0
projected_sor_batched.launches_warp = 0


def _warp_plan(n: int):
    """The rows each lane of the warp route holds for n-point systems:
    ``2 ceil(n / 64)``, even so that a row's colour is fixed by its slot;
    None when that exceeds the kernel's register chunk (``n > 256``): the
    first design, which a 16-row chunk did not beat."""
    ch = 2 * -(-n // 64)
    return ch if ch <= _MAX_CH else None


def _psor_library():
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_psor_batched
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_psor(lower, diag, upper, b, g, x0, omega, n_iter):
    """One solve on the current stream, on the route :func:`_warp_plan`
    picks from n: (x, residual)."""
    if _warp_plan(b.shape[1]) is not None:
        return _launch_psor_warp(lower, diag, upper, b, g, x0, omega, n_iter)
    x = _launch_psor_first(lower, diag, upper, b, g, x0, omega, n_iter)
    return x, _residual(lower, diag, upper, b, g, x)


@functools.lru_cache(maxsize=None)
def _warp_library():
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_psor_warp
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _warp_launcher(lower, diag, upper, b, g, x0, omega, n_iter):
    """The warp kernel bound to these operands, read where they lie, and to
    fresh outputs x (B, n) and residuals (B,): ``(launch, x, resid)``, where
    each ``launch()`` is one launch on the current stream returning its CUDA
    error (0 = launched)."""
    B, n = b.shape
    ops = [_batch_stride(a) for a in (lower, diag, upper, b, g)]
    start = None if x0 is None else _batch_stride(x0)
    x = torch.empty((B, n), dtype=torch.float32, device=b.device)
    resid = torch.empty((B,), dtype=torch.float32, device=b.device)
    fn = _warp_library()

    def launch():
        return fn(*(a.data_ptr() for a, _ in ops),
                  None if start is None else start[0].data_ptr(), x.data_ptr(),
                  resid.data_ptr(), *(s for _, s in ops), 0 if start is None else start[1],
                  B, n, n_iter, float(omega), torch.cuda.current_stream(b.device).cuda_stream)

    return launch, x, resid


def _launch_psor_warp(lower, diag, upper, b, g, x0, omega, n_iter):
    """The warp route: the operands read where they lie, x (B, n) and each
    system's residual written by the kernel; the residuals' max is one more
    launch when B > 1."""
    B = b.shape[0]
    launch, x, resid = _warp_launcher(lower, diag, upper, b, g, x0, omega, n_iter)
    err = launch()
    if err != 0:
        raise RuntimeError(f"batched PSOR launch failed: CUDA error {err}")
    projected_sor_batched.launches += 1
    projected_sor_batched.launches_warp += 1
    return x, (resid.max() if B > 1 else resid.reshape(()))


def _first_launcher(lower, diag, upper, b, g, x0, omega, n_iter):
    """The first design's kernel bound to row-aligned (B, n) copies of the
    operands (lo[:, 0] = 0, up[:, n-1] = 0) and to a fresh x (B, n):
    ``(launch, x)``, each ``launch()`` one launch on the current stream
    returning its CUDA error (0 = launched)."""
    B, n = b.shape
    zero = torch.zeros_like(b[:, :1])
    ins = [torch.cat([zero, lower], 1), diag.contiguous(), torch.cat([upper, zero], 1),
           b.contiguous(), g.contiguous()]
    start = None if x0 is None else x0.contiguous()
    x = torch.empty((B, n), dtype=torch.float32, device=b.device)
    fn = _psor_library()

    def launch():
        return fn(*(t.data_ptr() for t in ins), None if start is None else start.data_ptr(),
                  x.data_ptr(), B, n, n_iter, float(omega),
                  torch.cuda.current_stream(b.device).cuda_stream)

    return launch, x


def _launch_psor_first(lower, diag, upper, b, g, x0, omega, n_iter):
    """The first design: one launch on row-aligned operands; x alone."""
    launch, x = _first_launcher(lower, diag, upper, b, g, x0, omega, n_iter)
    err = launch()
    if err != 0:
        raise RuntimeError(f"batched PSOR launch failed: CUDA error {err}")
    projected_sor_batched.launches += 1
    return x


class BrennanSchwartzFactors(NamedTuple):
    """Elimination state for a time-INDEPENDENT operator (see
    :func:`brennan_schwartz_factor`)."""

    m: torch.Tensor      # (..., n) elimination multipliers; m[..., n-1] = 0
    inv_d: torch.Tensor  # (..., n) reciprocal eliminated pivots
    lo: torch.Tensor     # (..., n) oriented row-aligned sub-diag; lo[..., 0] = 0
    rev: torch.Tensor    # (..., 1) sweep-direction flags


def _flip_where(rev, a):
    """``a`` reversed along the last axis where ``rev`` is set."""
    return torch.where(rev, torch.flip(a, (-1,)), a)


def brennan_schwartz_factor(lower, diag, upper, reverse=False) -> BrennanSchwartzFactors:
    """Eliminate the matrix once for repeated :func:`brennan_schwartz_apply`
    (the division-heavy half of the pass depends only on the operator)."""
    lower, diag, upper = (torch.as_tensor(a) for a in (lower, diag, upper))
    n = diag.shape[-1]
    rev = torch.as_tensor(reverse, device=diag.device)
    batch = torch.broadcast_shapes(lower.shape[:-1], diag.shape[:-1],
                                   upper.shape[:-1], rev.shape)
    rev = rev.expand(batch)[..., None]
    # orient so the contact end is index 0; reversing the index order swaps
    # the roles of the two off-diagonal bands
    lower_b, upper_b = lower.expand(batch + (n - 1,)), upper.expand(batch + (n - 1,))
    lo = torch.where(rev, torch.flip(upper_b, (-1,)), lower_b)
    up = torch.where(rev, torch.flip(lower_b, (-1,)), upper_b)
    di = _flip_where(rev, diag.expand(batch + (n,)))

    # eliminate the super-diagonal from the far end (i = n-1 down to 0);
    # row i couples to row i+1 through up[i]
    d_next = di[..., n - 1]
    ms, ds = [], [d_next]
    for i in range(n - 2, -1, -1):
        m_i = up[..., i] / d_next
        d_next = di[..., i] - m_i * lo[..., i]
        ms.append(m_i)
        ds.append(d_next)
    zero = torch.zeros(batch + (1,), dtype=diag.dtype, device=diag.device)
    m = torch.cat([torch.stack(ms[::-1], -1), zero], -1)
    d_tilde = torch.stack(ds[::-1], -1)
    return BrennanSchwartzFactors(m, 1.0 / d_tilde, torch.cat([zero, lo], -1), rev)


def brennan_schwartz_apply(factors: BrennanSchwartzFactors, b, g) -> torch.Tensor:
    """Projected solve with precomputed factors; returns x only."""
    m, inv_d, lo, rev = factors
    b, g = torch.as_tensor(b), torch.as_tensor(g)
    n = m.shape[-1]
    batch = torch.broadcast_shapes(m.shape[:-1], b.shape[:-1], g.shape[:-1])
    bb = _flip_where(rev, b.expand(batch + (n,)))
    gg = _flip_where(rev, g.expand(batch + (n,)))
    m, inv_d, lo = (a.expand(batch + (n,)) for a in (m, inv_d, lo))

    # eliminate the rhs from the far end
    b_next = bb[..., n - 1]
    bts = [b_next]
    for i in range(n - 2, -1, -1):
        b_next = bb[..., i] - m[..., i] * b_next
        bts.append(b_next)
    bts = bts[::-1]

    # forward substitution INTO the contact end, projecting each row
    x = torch.maximum(bts[0] * inv_d[..., 0], gg[..., 0])
    xs = [x]
    for i in range(1, n):
        x = torch.maximum((bts[i] - lo[..., i] * x) * inv_d[..., i], gg[..., i])
        xs.append(x)
    return _flip_where(rev, torch.stack(xs, -1))


def brennan_schwartz(lower, diag, upper, b, g, reverse=False):
    """EXACT tridiagonal LCP solve in one projected pass (Brennan-Schwartz).

    When the contact region {x = g} is connected and anchored at ONE end of
    the grid (American exercise in S, the OU entry/exit problems), the LCP
    is solved exactly by eliminating *away* from the contact end and
    back-substituting *into* it with a per-row projection (Brennan &
    Schwartz 1977; Jaillet-Lamberton-Lapeyre 1990 for M-matrices).
    ``reverse=False`` puts contact at the LEFT end (low index),
    ``reverse=True`` at the right; ``reverse`` may be a bool tensor over the
    leading batch dims to mix directions in one call.  Shapes as
    :func:`projected_sor`.  Returns (x, residual).
    """
    lower, diag, upper, b, g = (torch.as_tensor(a) for a in (lower, diag, upper, b, g))
    n = diag.shape[-1]
    batch = torch.broadcast_shapes(lower.shape[:-1], diag.shape[:-1], b.shape[:-1],
                                   g.shape[:-1], torch.as_tensor(reverse).shape)
    x = brennan_schwartz_apply(brennan_schwartz_factor(lower, diag, upper, reverse), b, g)
    resid = _residual(lower.expand(batch + (n - 1,)), diag.expand(batch + (n,)),
                      upper.expand(batch + (n - 1,)), b.expand(batch + (n,)),
                      g.expand(batch + (n,)), x)
    return x, resid
