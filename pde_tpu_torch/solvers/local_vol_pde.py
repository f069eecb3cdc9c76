"""Local-volatility 1D PDE solver in log space (twin of
``pde_tpu/solvers/local_vol_pde.py``):

    V_t + 0.5 sigma(S,t)^2 V_xx + (r - q - 0.5 sigma(S,t)^2) V_x - r V = 0

in x = ln S, with a theta-scheme in time (Crank-Nicolson or implicit).

* :func:`solve` — one option; a loop over the steps that rebuilds the
  three diagonals from ``vol_fn(s_grid, t)`` each step and solves through
  :func:`~pde_tpu_torch.ops.tridiag.tridiagonal_solve`.  Any dtype, and
  differentiable by autograd.
* :func:`solve_fused` / :func:`solve_fused_batch` — the whole march of a
  book runs in ONE launch of the K3 kernel
  (:mod:`pde_tpu_torch.ops.cn1d_tv_fused`).  On a
  :class:`~pde_tpu_torch.models.local_vol.SurfaceInterpolator` the kernel
  builds every per-step operator row from the surface inside the march
  (its surface route, for grids up to 518 rows:
  :func:`~pde_tpu_torch.ops.cn1d_tv_fused.surface_route_fits`); for any
  other ``vol_fn``, or a longer grid, the sigma(s, t) lattice and
  every operator row are built up front and the kernel reads them.
  ``route="scan"`` marches the lattice's bands through the batched
  :func:`~pde_tpu_torch.ops.tridiag.thomas` instead, with a true divide at
  every pivot.

Port notes: the reference builds an interpolator surface's lattice as two
one-hot matmuls because its TPU has no fast gather; here it is a direct
gather bilinear lookup with the same bracket semantics
(:func:`_band_lattice_batch`), so no matmul, and no TF32 question, is on
the path.  The batch needs no 128-lane padding and there is no
``interpret`` argument (both TPU artifacts); the reference's
``route="pallas"`` is accepted as an alias of ``"fused"``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..core import grids
from ..core.precision import resolve_device, result_dtype, to_tensor
from ..models.local_vol import SurfaceInterpolator
from ..ops.cn1d_tv_fused import (fused_cn_march_1d_tv, fused_cn_march_1d_tv_surface,
                                 operator_rows, strike_brackets, surface_route_fits,
                                 surface_sigma)
from ..ops.tridiag import thomas, tridiagonal_solve
from ..utils.profiling import span

__all__ = ["LVPDEResult", "solve", "solve_fused", "solve_fused_batch"]

_W = {"crank_nicolson": 0.5, "implicit": 1.0}
_ROUTES = ("fused", "pallas", "scan")


class LVPDEResult(NamedTuple):
    price: torch.Tensor
    delta: torch.Tensor
    gamma: torch.Tensor
    prices: torch.Tensor     # value on the grid at t=0
    spot_grid: torch.Tensor
    early_exercise_optimal: torch.Tensor


def _extract(V, s_grid, S0, K, is_call, american):
    """Price/delta/gamma at S0 and the early-exercise flag from the t=0
    values; ``V``/``s_grid`` (n,) for one option or (B, n) for a book,
    ``is_call``/``american`` bool tensors of the batch shape."""
    price, delta, gamma = grids.price_delta_gamma(s_grid, V, S0)
    S0 = to_tensor(S0, price.dtype, price.device)
    K = to_tensor(K, price.dtype, price.device)
    payoff_s0 = torch.where(is_call, torch.clamp_min(S0 - K, 0.0),
                            torch.clamp_min(K - S0, 0.0))
    early_ex = american & (price > payoff_s0 + 1e-10)
    return LVPDEResult(price, delta, gamma, V, s_grid, early_ex)


def solve(
    vol_fn: Callable,
    S0,
    *,
    K,
    T,
    r=0.0,
    q=0.0,
    is_call=True,
    american: bool = False,
    n_space: int = 200,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    scheme: str = "crank_nicolson",
    device=None,
    dtype=None,
) -> LVPDEResult:
    """Backward theta-scheme march under ``sigma = vol_fn(s_grid, t)``.

    ``vol_fn`` maps (spot levels (n,), scalar calendar time t in [0, T]) to
    per-node vols (n,): a :class:`~pde_tpu_torch.models.local_vol.SurfaceInterpolator`
    for a Dupire surface, or ``lambda s, t: torch.full_like(s, sig)`` for
    Black-Scholes.  American exercise by per-step projection.  Runs on
    ``device`` (default: the CUDA card) in ``dtype`` (default: the inputs'
    tensor dtype, else torch's default float).
    """
    device = resolve_device(device)
    dt_ = dtype or result_dtype(K, T, S0)
    K = to_tensor(K, dt_, device)
    T = to_tensor(T, dt_, device)
    w = _W[scheme]
    s_grid = torch.exp(grids.linspace(torch.log(K * s_min_mult),
                                      torch.log(K * s_max_mult), n_space))
    dx = torch.log(s_grid[-1] / s_grid[0]) / (n_space - 1)
    dt = T / n_time

    call = torch.as_tensor(bool(is_call), device=device)
    payoff = torch.where(call, torch.clamp_min(s_grid - K, 0.0),
                         torch.clamp_min(K - s_grid, 0.0))
    idx = torch.arange(n_space, device=device)
    is_interior = (idx > 0) & (idx < n_space - 1)
    zero = torch.zeros((), dtype=dt_, device=device)

    V = payoff
    for k in range(1, n_time + 1):
        tau = dt * float(k)
        # implicit side at the new level (time-to-expiry tau), explicit side
        # at the old one
        L_m_n, L_c_n, L_p_n = operator_rows(vol_fn(s_grid, T - tau), dx, r, q)
        if w < 1.0:
            sig_old = vol_fn(s_grid, torch.minimum(T - tau + dt, T))
            L_m_o, L_c_o, L_p_o = operator_rows(sig_old, dx, r, q)
            LV = (L_m_o[1:-1] * V[:-2] + L_c_o[1:-1] * V[1:-1]
                  + L_p_o[1:-1] * V[2:])
            rhs = torch.cat([V[:1], V[1:-1] + (1.0 - w) * dt * LV, V[-1:]])
        else:
            rhs = V
        diag = torch.where(is_interior, 1.0 - w * dt * L_c_n, 1.0 + zero)
        lower = torch.where(is_interior[1:], -w * dt * L_m_n[1:], zero)
        upper = torch.where(is_interior[:-1], -w * dt * L_p_n[:-1], zero)
        V = tridiagonal_solve(lower, diag, upper, rhs)
        # Dirichlet rows with both discounts over time-to-expiry
        df_r = torch.exp(-r * tau)
        df_q = torch.exp(-q * tau)
        bc_lo = torch.where(call, zero, K * df_r - s_grid[0] * df_q)
        bc_hi = torch.where(call, s_grid[-1] * df_q - K * df_r, zero)
        V = torch.cat([bc_lo[None], V[1:-1], bc_hi[None]])
        if american:
            V = torch.maximum(V, payoff)

    return _extract(V, s_grid, S0, K, call, torch.as_tensor(bool(american),
                                                            device=device))


def _band_lattice(vol_fn, s_grid, dx, T, r, q, n_time):
    """Operator rows of ONE option for all time levels, ``(n_time+1, 3n)``:
    level j is calendar time T - j dt (j = 0 is expiry)."""
    dt = T / n_time
    j = torch.arange(n_time + 1, dtype=s_grid.dtype, device=s_grid.device)
    t_levels = torch.minimum(torch.clamp_min(T - dt * j, 0.0), T)
    sig = torch.stack([vol_fn(s_grid, t) for t in t_levels])   # (nT+1, n)
    return torch.cat(operator_rows(sig, dx, r, q), dim=-1)


def _band_lattice_batch(interp: SurfaceInterpolator, sg, dx, T, r, q, n_time):
    """The whole book's lattice ``(n_time+1, 3n, B)`` by direct gather
    bilinear lookup in (ln K, t): twin of the reference's
    ``_band_lattice_batch_mxu``, with its bracket semantics — the bracket
    is the count of knots <= x, minus one, clipped (``searchsorted``
    right); weights clipped to [0, 1]; flat beyond the pillars.  ``sg`` is
    the book's spot grid (n, B), ``T`` its maturities (B,)."""
    sig = _sigma_lattice_batch(interp, sg, T, n_time)
    return torch.cat(operator_rows(sig, dx, r, q), dim=1)


def _sigma_lattice_batch(interp: SurfaceInterpolator, sg, T, n_time):
    """The local vol of :func:`_band_lattice_batch` at every node and level,
    ``(n_time+1, n, B)``."""
    f, dev = sg.dtype, sg.device
    log_k, tt, vols = (a.to(device=dev, dtype=f)
                       for a in (interp.log_k, interp.t, interp.vols))
    ix, wx = strike_brackets(log_k, torch.log(sg).T.contiguous())   # (B, n)
    levels = torch.arange(n_time + 1, dtype=f, device=dev)
    sig = surface_sigma(tt, vols, ix, wx, T, T / n_time, levels)    # (B, nT+1, n)
    return sig.permute(1, 2, 0).contiguous()


def _book_bands(vol_fn, sg, dx, T, r, q, n_time):
    """Book band lattice: the gather route for :class:`SurfaceInterpolator`
    surfaces, option by option for any other callable."""
    if isinstance(vol_fn, SurfaceInterpolator):
        return _band_lattice_batch(vol_fn, sg, dx, T, r, q, n_time)
    return torch.stack([_band_lattice(vol_fn, sg[:, b], dx, T[b], r, q, n_time)
                        for b in range(sg.shape[1])], dim=2)


def _grid_inputs(K, T, call_f, amer_f, r, q, n_space, n_time, s_min_mult, s_max_mult):
    """K3's inputs but the bands, for a book of (B,) float32 tensors on one
    device: ``pay`` (n, B), ``sc`` (8, B), the book's spot grid ``sg`` (n, B)
    and the log-spot step ``dx``."""
    n, B = n_space, K.shape[0]
    f32, dev = torch.float32, K.device
    # K-scaled log-moneyness grid shared across the book: dx is
    # option-independent; spaced in float64 and rounded once
    x = torch.linspace(math.log(s_min_mult), math.log(s_max_mult), n,
                       dtype=torch.float64, device=dev).to(f32)
    dx = (math.log(s_max_mult) - math.log(s_min_mult)) / (n - 1)
    ex = torch.exp(x)
    sg = ex[:, None] * K[None, :]                               # (n, B)
    pay = torch.where(call_f[None, :] > 0.5,
                      torch.clamp_min(ex - 1.0, 0.0)[:, None] * K[None, :],
                      torch.clamp_min(1.0 - ex, 0.0)[:, None] * K[None, :])
    full = lambda v: torch.full((B,), v, dtype=f32, device=dev)  # noqa: E731
    sc = torch.stack([T / n_time, full(r), full(q), K, call_f, amer_f, sg[0], sg[-1]])
    return pay, sc, sg, dx


def _surface_inputs(interp: SurfaceInterpolator, sg):
    """The surface route's inputs beside :func:`_grid_inputs`': the nodes'
    ln S ``xq`` (n, B), then the surface's ln K knots, maturity knots and
    vols in float32 on the book's device."""
    return (torch.log(sg), *(a.to(device=sg.device, dtype=torch.float32).contiguous()
                             for a in (interp.log_k, interp.t, interp.vols)))


def _march_inputs(vol_fn, K, T, call_f, amer_f, r, q, n_space, n_time,
                  s_min_mult, s_max_mult):
    """K3's inputs for a book of (B,) float32 tensors on one device, in its
    public layout ``(pay, bands, sc)``, plus the book's spot grid (n, B)."""
    pay, sc, sg, dx = _grid_inputs(K, T, call_f, amer_f, r, q, n_space, n_time,
                                   s_min_mult, s_max_mult)
    bands = _book_bands(vol_fn, sg, dx, T, r, q, n_time)        # (nT+1, 3n, B)
    return pay, bands, sc, sg


def _march_scan(pay, bands, sg, T, K, r, q, call_f, amer_f, n_time, w):
    """The ``route="scan"`` march: the kernel's step order, with each step's
    system solved by the batched :func:`thomas` (options on the leading
    axis, a true divide at every pivot)."""
    n, B = pay.shape
    bands = bands.reshape(n_time + 1, 3, n, B)
    dts = T / n_time
    mi = torch.zeros((n, 1), dtype=pay.dtype, device=pay.device)
    mi[1:-1] = 1.0
    zero_row = torch.zeros((1, B), dtype=pay.dtype, device=pay.device)
    V = pay
    for k in range(n_time):
        (Lmo, Lco, Lpo), (Lmn, Lcn, Lpn) = bands[k], bands[k + 1]
        LV = (Lmo * torch.cat([zero_row, V[:-1]]) + Lco * V
              + Lpo * torch.cat([V[1:], zero_row]))
        rhs = V + ((1.0 - w) * dts) * (mi * LV)
        li = mi * (-(w * dts) * Lmn)
        di = mi * (1.0 - (w * dts) * Lcn) + (1.0 - mi)
        ui = mi * (-(w * dts) * Lpn)
        Vn = thomas(li[1:].T, di.T, ui[:-1].T, rhs.T).T
        tau = dts * float(k + 1)
        dfr = torch.exp(-r * tau)
        dfq = torch.exp(-q * tau)
        bc0 = (1.0 - call_f) * (K * dfr - sg[0] * dfq)
        bcN = call_f * (sg[-1] * dfq - K * dfr)
        Vn = torch.cat([bc0[None], Vn[1:-1], bcN[None]])
        V = Vn + amer_f * (torch.maximum(Vn, pay) - Vn)
    return V


def solve_fused(vol_fn: Callable, S0, *, K, T, r=0.0, q=0.0, is_call=True,
                american: bool = False, n_space: int = 200, n_time: int = 100,
                s_min_mult: float = 0.2, s_max_mult: float = 5.0,
                scheme: str = "crank_nicolson", device=None) -> LVPDEResult:
    """:func:`solve` through the fused march: the one-option view of a
    one-option :func:`solve_fused_batch`."""
    res = solve_fused_batch(
        vol_fn, S0, K=K, T=T, r=r, q=q, is_call=is_call, american=american,
        n_space=n_space, n_time=n_time, s_min_mult=s_min_mult,
        s_max_mult=s_max_mult, scheme=scheme, device=device)
    return LVPDEResult(*(a[0] for a in res))


def solve_fused_batch(
    vol_fn: Callable,
    S0,
    *,
    K,
    T,
    r=0.0,
    q=0.0,
    is_call=True,
    american=False,
    n_space: int = 200,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    scheme: str = "crank_nicolson",
    route: str = "fused",
    device=None,
) -> LVPDEResult:
    """A whole option BOOK on one local-vol surface in one march.

    ``K``/``T``/``is_call``/``american``/``S0`` broadcast along one batch
    axis (mixed strikes, maturities, calls and puts, European and
    American); each option gets its own K-scaled grid and its own
    dt = T_b / n_time; ``r`` and ``q`` are scalars.  The book marches on
    ``device`` (default: the CUDA card) in float32.  ``route``: ``"fused"``
    (default; ``"pallas"`` is its alias) launches the K3 kernel on a CUDA
    device and runs its plain twin on the CPU, on the kernel's surface route
    when ``vol_fn`` is a :class:`SurfaceInterpolator` and the grid fits it,
    else on a band lattice built up front; ``"scan"`` is the batched Thomas
    march on the lattice.
    """
    if route not in _ROUTES:
        raise ValueError(f"unknown route {route!r}; expected one of {_ROUTES}")
    with span("pde_tpu_torch.local_vol_pde.solve_fused_batch"):
        device = resolve_device(device)
        vals = [torch.atleast_1d(torch.as_tensor(a, device=device).to(torch.float32))
                for a in (K, T, is_call, american, S0)]
        B = max(a.shape[0] for a in vals)
        K_b, T_b, call_f, amer_f, S0_b = (a.expand(B).contiguous() for a in vals)
        # the kernel builds the bands from the surface where it can, else
        # reads a lattice built up front
        on_surface = (route != "scan" and isinstance(vol_fn, SurfaceInterpolator)
                      and surface_route_fits(n_space, vol_fn.log_k.shape[0],
                                             vol_fn.t.shape[0]))
        with span("pde_tpu_torch.local_vol_pde.bands"):
            pay, sc, sg, dx = _grid_inputs(K_b, T_b, call_f, amer_f, r, q, n_space, n_time,
                                           s_min_mult, s_max_mult)
            if on_surface:
                xq, *surface = _surface_inputs(vol_fn, sg)
            else:
                bands = _book_bands(vol_fn, sg, dx, T_b, r, q, n_time)
        w = _W[scheme]
        with span("pde_tpu_torch.local_vol_pde.march"):
            if route == "scan":
                V = _march_scan(pay, bands, sg, T_b, K_b, r, q, call_f, amer_f, n_time, w)
            elif on_surface:
                V = fused_cn_march_1d_tv_surface(pay, xq, sc, T_b, *surface, n_space=n_space,
                                                 n_time=n_time, dx=dx, r=r, q=q, w=w)
            else:
                V = fused_cn_march_1d_tv(pay, bands, sc, n_space=n_space, n_time=n_time,
                                         w=w)
        with span("pde_tpu_torch.local_vol_pde.readout"):
            return _extract(V.T, sg.T, S0_b, K_b, call_f > 0.5, amer_f > 0.5)
