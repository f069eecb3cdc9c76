"""Heston 2D PDE solver — ADI in log-spot coordinates (twin of
``pde_tpu/solvers/heston_adi.py``).

Boundary treatment (In 't Hout & Foulon 2010): v = 0 is a PDE row with a
one-sided V_v; v = v_max and both S edges are Dirichlet with both
discounts.

* :func:`solve`, :func:`solve_batch` — the scan route: a Python loop over
  the time steps (Douglas, Craig-Sneyd or Hundsdorfer-Verwer splitting;
  European, American by projection or Ikonen-Toivanen), the book on a
  leading batch axis, so a step costs the same launches for any B.  Each
  implicit sweep is a factored Thomas solve, or on float32 tensors on the
  card outside autograd one launch of K5
  (:func:`~pde_tpu_torch.ops.tridiag.tridiagonal_solve`).  Any dtype;
  differentiable by autograd, which :func:`greeks_ad` uses.
* :func:`solve_fused` — one option through the fused march K2
  (:func:`~pde_tpu_torch.ops.adi_fused.fused_douglas_march`), float32.
* :func:`solve_fused_batch` — a book on K-scaled grids, where dx is the
  same for every option, so the S operator depends only on (v_j, option)
  and the whole book marches in one launch of K1.

Port notes: the batch needs no padding to 128-lane blocks (a TPU lane
artifact), and the reference's ``unroll``/``interpret`` arguments (a Mosaic
loop hint and its CPU interpreter) have no counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import grids
from ..core.precision import resolve_device, result_dtype, to_tensor
from ..ops.adi_fused import fused_douglas_march, fused_douglas_march_batched
from ..ops.tridiag import (kernel_route, thomas_factor, thomas_solve_factored,
                           tridiagonal_solve)
from ..utils.profiling import span

__all__ = ["HestonPDEParams", "HestonPDEResult", "solve", "solve_fused",
           "solve_batch", "solve_fused_batch", "greeks_ad"]


class HestonPDEParams(NamedTuple):
    """Inputs (grid defaults match the reference, heston_pde.hpp:56-61).

    ``american_method``: "projection" (per-step max(V, payoff), the
    reference's splitting) or "it_lcp" (Ikonen-Toivanen splitting with an
    exercise-premium multiplier).  ``scheme``: "douglas", "craig_sneyd"
    (the reference's family: a mixed-term corrector and a second sweep
    pair) or "hv" (Hundsdorfer-Verwer)."""

    kappa: float = 2.0
    theta: float = 0.04
    sigma: float = 0.3
    rho: float = -0.7
    v0: float = 0.04
    r: float = 0.05
    q: float = 0.0
    T: float = 1.0
    K: float = 100.0
    is_call: bool = True
    american: bool = False
    n_spot: int = 100
    n_vol: int = 50
    n_time: int = 100
    s_min_mult: float = 0.2
    s_max_mult: float = 5.0
    v_max: float = 1.0
    american_method: str = "projection"
    scheme: str = "douglas"


class HestonPDEResult(NamedTuple):
    price: torch.Tensor
    delta: torch.Tensor
    gamma: torch.Tensor
    vega: torch.Tensor
    theta: torch.Tensor
    prices: torch.Tensor  # V(S, v) at t=0
    spot_grid: torch.Tensor
    vol_grid: torch.Tensor


def _a1_diags(v_grid, dx, r, q):
    """S-direction (log-coordinate) operator rows for every v level.

    A1 = 0.5 v V_xx + (r - q - 0.5 v) V_x - 0.5 r V on interior rows.
    ``r``/``q`` of shape (..., 1) give a batch.  Returns the interior
    (lower, diag, upper) values, each (..., nv, 1).
    """
    a = 0.5 * v_grid / (dx * dx)  # (nv,)
    b = (r - q - 0.5 * v_grid) / (2.0 * dx)
    return (a - b)[..., None], (-2.0 * a - 0.5 * r)[..., None], (a + b)[..., None]


def _a2_diags(v_grid, dv, kappa, theta, sigma, r):
    """v-direction operator (identical for every S row).

    Interior: 0.5 sigma^2 v V_vv + kappa(theta - v) V_v - 0.5 r V, with the
    convection central where the scheme stays an M-matrix and first-order
    upwind where it would not.  v = 0 row: kappa*theta * one-sided V_v -
    0.5 r V.  v = v_max row: zero (Dirichlet).  Parameters of shape (..., 1)
    give a batch; returns diagonals (..., nv-1), (..., nv), (..., nv-1).
    """
    vj = v_grid[1:-1]
    d = 0.5 * sigma * sigma * vj / (dv * dv)
    adv = kappa * (theta - vj) / (2.0 * dv)

    central_ok = d >= torch.abs(adv)
    up = adv > 0.0  # convection pushes toward larger v
    lo_j = torch.where(central_ok, d - adv, torch.where(up, d, d - 2.0 * adv))
    up_j = torch.where(central_ok, d + adv, torch.where(up, d + 2.0 * adv, d))
    di_j = -(lo_j + up_j)  # row sum zero before the -r/2 discount term

    col = lambda x: torch.as_tensor(x, dtype=d.dtype, device=d.device).expand(*d.shape[:-1], 1)  # noqa: E731
    zero = col(0.0)
    # v = 0 boundary row: first-order one-sided convection (diffusion is 0)
    c = col(kappa * theta / dv)
    rr = col(r)
    lower = torch.cat([lo_j, zero], dim=-1)
    diag = torch.cat([-c - 0.5 * rr, di_j - 0.5 * rr, zero], dim=-1)
    upper = torch.cat([c, up_j], dim=-1)
    return lower, diag, upper


def _assemble_a1(nS, nv, lo_val, di_val, up_val):
    """Expand per-level constants into batched tridiagonals (..., nv, nS*)."""
    ar = torch.arange(nS, device=lo_val.device)
    interior = ((ar > 0) & (ar < nS - 1)).to(lo_val.dtype)
    lower = lo_val.expand(*lo_val.shape[:-2], nv, nS - 1) * interior[1:]
    diag = di_val.expand(*di_val.shape[:-2], nv, nS) * interior
    upper = up_val.expand(*up_val.shape[:-2], nv, nS - 1) * interior[:-1]
    return lower, diag, upper


def _apply_a1(V, lower, diag, upper):
    """A1 V with the batched-diagonal representation (systems along the S
    axis, -2, of V)."""
    out = diag.transpose(-1, -2) * V
    out[..., 1:, :] += lower.transpose(-1, -2) * V[..., :-1, :]
    out[..., :-1, :] += upper.transpose(-1, -2) * V[..., 1:, :]
    return out


def _apply_a2(V, lower, diag, upper):
    """A2 V, acting along the v axis (-1); same diagonals for all rows."""
    out = V * diag[..., None, :]
    out[..., :, 1:] += V[..., :, :-1] * lower[..., None, :]
    out[..., :, :-1] += V[..., :, 1:] * upper[..., None, :]
    return out


def _apply_a0(V, v_grid, dx, dv, rho, sigma):
    """Mixed-derivative term rho sigma v V_xv (explicit only); ``rho``,
    ``sigma`` (and ``dx``) of shape (..., 1, 1) give a batch."""
    V_xv = (V[..., 2:, 2:] - V[..., 2:, :-2] - V[..., :-2, 2:] + V[..., :-2, :-2]) / (4.0 * dx * dv)
    out = rho * sigma * v_grid[None, 1:-1] * V_xv
    return torch.nn.functional.pad(out, (1, 1, 1, 1))


def _sweep_solvers(i1, i2, *route):
    """The implicit sweeps of grids V (..., nS, nv), as (solve_s, solve_v):
    S systems one a variance level with the bands ``i1`` (..., nv, nS*), v
    systems one an S row with the bands ``i2`` (..., nv*), shared by the
    rows.  On float32 tensors on the card outside autograd (asked of the
    bands and of ``route``, the other tensors the right-hand sides hang on)
    each sweep is one K5 launch over the flattened systems, the v bands
    expanded over the rows (at batch stride 0 for one option); elsewhere the
    factored Thomas solve, factored once (the operators are
    time-independent)."""
    nv, nS = i1[1].shape[-2:]
    if kernel_route(*route, *i1, *i2):
        s_bands = [b.reshape(-1, b.shape[-1]) for b in i1]
        v_bands = [b[..., None, :].expand(*b.shape[:-1], nS, b.shape[-1]).reshape(-1, b.shape[-1])
                   for b in i2]

        def solve_s(rhs):
            rhs_t = rhs.transpose(-1, -2)
            y = tridiagonal_solve(*s_bands, rhs_t.reshape(-1, nS), use_kernel=True)
            return y.reshape(rhs_t.shape).transpose(-1, -2)

        def solve_v(rhs):
            return tridiagonal_solve(*v_bands, rhs.reshape(-1, nv), use_kernel=True).reshape(rhs.shape)

        return solve_s, solve_v
    f1, f2 = thomas_factor(*i1), thomas_factor(*(b[..., None, :] for b in i2))
    return (lambda rhs: thomas_solve_factored(f1, rhs.transpose(-1, -2)).transpose(-1, -2),
            lambda rhs: thomas_solve_factored(f2, rhs))


def _readout(V, s_grid, v_grid, dv, S0, v0, T, LV, split_davg):
    """Price and grid Greeks per option from V (B, nS, nv) on spot grids
    (B, nS) and the shared v grid; ``LV`` = (A0 + A1 + A2) V gives theta.
    ``split_davg`` takes the mean spacing as the scan route does,
    0.5 ((s_i - s_{i-1}) + (s_{i+1} - s_i)); otherwise 0.5 (s_{i+1} - s_{i-1})."""
    nS, nv = V.shape[-2:]
    price = grids.interp_bilinear(s_grid, v_grid, V, S0, v0)
    i = torch.clamp(grids.find_index(s_grid, S0), 1, nS - 2)
    j = torch.clamp(grids.find_index(v_grid, v0), 1, nv - 2)
    at = lambda di, dj: grids.take2(V, i + di, j + dj)   # noqa: E731
    s_at = lambda di: grids.take(s_grid, i + di)          # noqa: E731
    delta = (at(1, 0) - at(-1, 0)) / (s_at(1) - s_at(-1))
    if split_davg:
        davg = 0.5 * ((s_at(0) - s_at(-1)) + (s_at(1) - s_at(0)))
    else:
        davg = 0.5 * (s_at(1) - s_at(-1))
    gamma = (at(1, 0) - 2.0 * at(0, 0) + at(-1, 0)) / (davg * davg)
    dV_dv = (at(0, 1) - at(0, -1)) / (2.0 * dv)
    # vega ~ 2 sqrt(v0) T dV/dv (heston_pde.hpp:534-547)
    vega = 2.0 * torch.sqrt(v0) * T * dV_dv
    theta_g = -grids.take2(LV, i, j)
    return price, delta, gamma, vega, theta_g


def _solve_core(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
    *,
    american: bool,
    american_method: str,
    n_spot: int,
    n_vol: int,
    n_time: int,
    s_min_mult: float,
    s_max_mult: float,
    v_max: float,
    remat: bool = False,
    scheme: str = "douglas",
) -> HestonPDEResult:
    """The scan march of a book: every input a (B,) tensor (``is_call``
    bool, the rest of one float dtype) on one device; only grid sizes, the
    American mode and the scheme are Python values.  The batch rides the
    leading axis of every operator and of V (B, nS, nv)."""
    nS, nv, nT = n_spot, n_vol, n_time
    B = K.shape[0]
    f, dev = K.dtype, K.device
    col = lambda a: a[:, None]          # noqa: E731  (B,) -> (B, 1)
    box = lambda a: a[:, None, None]    # noqa: E731  (B,) -> (B, 1, 1)
    # grids built by arithmetic, so gradients reach every endpoint
    x = grids.linspace(torch.log(K * s_min_mult), torch.log(K * s_max_mult), nS)
    s_grid = torch.exp(x)                                  # (B, nS)
    dx = (x[:, -1] - x[:, 0]) / (nS - 1)                   # (B,)
    v_grid = grids.linspace(torch.zeros((), dtype=f, device=dev),
                            torch.full((), v_max, dtype=f, device=dev), nv)
    dv = v_max / (nv - 1)
    dt = T / nT
    th = 0.5  # Douglas parameter

    payoff_1d = torch.where(col(is_call), torch.clamp_min(s_grid - col(K), 0.0),
                            torch.clamp_min(col(K) - s_grid, 0.0))
    payoff = payoff_1d[:, :, None].expand(B, nS, nv)

    lo_v, di_v, up_v = _a1_diags(v_grid, col(dx), col(r), col(q))
    a1_lower, a1_diag, a1_upper = _assemble_a1(nS, nv, lo_v, di_v, up_v)  # (B, nv, nS*)
    a2_lower, a2_diag, a2_upper = _a2_diags(v_grid, dv, col(kappa), col(theta),
                                            col(sigma), col(r))         # (B, nv*)
    # implicit system diagonals (I - th dt A)
    dt1, dt2 = box(dt), col(dt)
    i1 = (-th * dt1 * a1_lower, 1.0 - th * dt1 * a1_diag, -th * dt1 * a1_upper)
    i2 = (-th * dt2 * a2_lower, 1.0 - th * dt2 * a2_diag, -th * dt2 * a2_upper)

    # rho reaches the right-hand sides through A0 only
    solve_s, solve_v = _sweep_solvers(i1, i2, payoff_1d, rho)

    dx1, rho1, sigma1 = box(dx), box(rho), box(sigma)
    A0 = lambda V: _apply_a0(V, v_grid, dx1, dv, rho1, sigma1)     # noqa: E731
    A1 = lambda V: _apply_a1(V, a1_lower, a1_diag, a1_upper)      # noqa: E731
    A2 = lambda V: _apply_a2(V, a2_lower, a2_diag, a2_upper)      # noqa: E731

    def sweeps(Y0, a1V, a2V):
        Y1 = solve_s(Y0 - th * dt1 * a1V)
        return solve_v(Y1 - th * dt1 * a2V)

    def adi_step(V, source):
        """Douglas: explicit full step, then implicit S and v sweeps;
        Craig-Sneyd adds a mixed-term corrector and a second sweep pair,
        Hundsdorfer-Verwer a full-operator corrector anchored at the
        predictor.  ``source`` is the Ikonen-Toivanen multiplier."""
        a0V, a1V, a2V = A0(V), A1(V), A2(V)
        acc = a0V + a1V + a2V
        if source is not None:
            acc = acc + source
        Y0 = V + dt1 * acc
        Y2 = sweeps(Y0, a1V, a2V)
        if scheme == "craig_sneyd":
            Y0_tilde = Y0 + 0.5 * dt1 * (A0(Y2) - a0V)
            Y2 = sweeps(Y0_tilde, a1V, a2V)
        elif scheme == "hv":
            a1Y, a2Y = A1(Y2), A2(Y2)
            Y0_tilde = Y0 + 0.5 * dt1 * ((A0(Y2) + a1Y + a2Y) - (a0V + a1V + a2V))
            Y2 = sweeps(Y0_tilde, a1Y, a2Y)
        return Y2

    ii = torch.arange(nS, device=dev)[:, None]
    jj = torch.arange(nv, device=dev)[None, :]
    edge = (ii == 0) | (ii == nS - 1) | (jj == 0) | (jj == nv - 1)
    sg3, K3, call3 = s_grid[:, :, None], box(K), box(is_call)

    def apply_bc(V, tau):
        """Dirichlet boundaries at time-to-expiry tau (In 't Hout-Foulon)."""
        df_r, df_q = box(torch.exp(-r * tau)), box(torch.exp(-q * tau))
        V = torch.where(ii == 0, torch.where(call3, 0.0, K3 * df_r - sg3[:, :1] * df_q), V)
        V = torch.where(ii == nS - 1,
                        torch.where(call3, sg3[:, -1:] * df_q - K3 * df_r, 0.0), V)
        return torch.where(jj == nv - 1, torch.where(call3, sg3 * df_q, K3 * df_r), V)

    use_it = american and american_method == "it_lcp"

    def step(V, lam, tau):
        Vt = adi_step(V, lam)
        if use_it:
            # Ikonen-Toivanen: V_new - dt lam_new = Vt - dt lam, V_new >= g,
            # lam_new >= 0, lam_new (V_new - g) = 0
            W = Vt - dt1 * lam
            V_new = torch.maximum(payoff, W)
            lam = (V_new - W) / dt1
            Vt = V_new
        Vt = apply_bc(Vt, tau)
        if american and not use_it:
            Vt = torch.maximum(Vt, payoff)
        if use_it:
            # the Dirichlet edges are European: floor them at intrinsic
            Vt = torch.where(edge, torch.maximum(Vt, payoff), Vt)
        return Vt, lam

    V = payoff
    lam = torch.zeros_like(payoff) if use_it else None
    for k in range(1, nT + 1):
        tau = dt * float(k)
        if remat:
            # recompute each step on the backward pass instead of saving it
            V, lam = checkpoint(step, V, lam, tau, use_reentrant=False)
        else:
            V, lam = step(V, lam, tau)

    LV = A0(V) + A1(V) + A2(V)
    price, delta, gamma, vega, theta_g = _readout(V, s_grid, v_grid, dv, S0, v0, T,
                                                  LV, split_davg=True)
    return HestonPDEResult(price, delta, gamma, vega, theta_g, V, s_grid,
                           v_grid.expand(B, nv))


def _validate_params(params: HestonPDEParams) -> None:
    if params.kappa <= 0 or params.theta <= 0 or params.sigma <= 0:
        raise ValueError("kappa, theta, sigma must be positive")
    if abs(params.rho) >= 1:
        raise ValueError("|rho| must be < 1")
    if params.v0 <= 0 or params.T <= 0 or params.K <= 0:
        raise ValueError("v0, T, K must be positive")
    if params.scheme not in ("douglas", "craig_sneyd", "hv"):
        raise ValueError(f"unknown ADI scheme {params.scheme!r}")


_FLOATS = ("kappa", "theta", "sigma", "rho", "v0", "r", "q", "T", "K")


def _params_as_tensors(p: HestonPDEParams, S0, device, dtype):
    """The model/contract fields and S0 as 0-d tensors of ``dtype`` (default:
    the tensors' among them, else torch's default float) on ``device``."""
    vals = [getattr(p, k) for k in _FLOATS] + [S0]
    f = dtype or result_dtype(*vals)
    return [to_tensor(a, f, device) for a in vals]


def solve(params: HestonPDEParams, S0, device=None, dtype=None) -> HestonPDEResult:
    """Solve the Heston PDE on the scan route; price/Greeks at (S0, v0).

    Runs on ``device`` (default: the CUDA card) in ``dtype`` (default: the
    dtype of the tensors among the parameters and ``S0``, else torch's
    default float).  Batch over all inputs with :func:`solve_batch`.
    """
    _validate_params(params)
    device = resolve_device(device)
    *floats, S0 = (a.reshape(1) for a in _params_as_tensors(params, S0, device, dtype))
    call = torch.as_tensor(bool(params.is_call), device=device).reshape(1)
    res = _solve_core(
        *floats[:9], call, S0, american=bool(params.american),
        american_method=params.american_method, n_spot=params.n_spot,
        n_vol=params.n_vol, n_time=params.n_time, s_min_mult=params.s_min_mult,
        s_max_mult=params.s_max_mult, v_max=params.v_max, scheme=params.scheme)
    return HestonPDEResult(*(a[0] for a in res))


def solve_batch(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
    american: bool = False,
    american_method: str = "projection",
    n_spot: int = 100,
    n_vol: int = 50,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    v_max: float = 1.0,
    device=None,
    dtype=None,
) -> HestonPDEResult:
    """Price a whole BATCH of PDE problems in one march.

    Every array argument broadcasts against the others along one leading
    batch axis: mixed strikes, maturities, rates, Heston parameters, spot
    levels, calls AND puts march together (the reference prices one option
    per solver instance, heston_pde.hpp:56-150).  ``device``/``dtype`` as
    :func:`solve`.
    """
    device = resolve_device(device)
    floats = (kappa, theta, sigma, rho, v0, r, q, T, K, S0)
    f = dtype or result_dtype(*floats)
    vals = [torch.atleast_1d(to_tensor(a, f, device)) for a in floats]
    call = torch.atleast_1d(torch.as_tensor(is_call, device=device)) != 0
    n = max(a.shape[0] for a in vals + [call])
    *vals, S0 = (a.expand(n).contiguous() for a in vals)
    return _solve_core(
        *vals, call.expand(n).contiguous(), S0, american=american, american_method=american_method,
        n_spot=n_spot, n_vol=n_vol, n_time=n_time, s_min_mult=s_min_mult,
        s_max_mult=s_max_mult, v_max=v_max)


def greeks_ad(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
    american: bool = False,
    american_method: str = "projection",
    n_spot: int = 100,
    n_vol: int = 50,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    v_max: float = 1.0,
    remat: bool = False,
    device=None,
    dtype=None,
):
    """Adjoint (reverse-mode autograd) sensitivities through the whole scan
    march: price, delta and d/d{kappa, theta, sigma, rho, v0, r, q, T} from
    one backward pass (the reference bumps the grid once per Greek,
    heston_pde.hpp:520-560).  ``remat=True`` recomputes each step on the
    backward pass (``torch.utils.checkpoint``) instead of keeping all
    n_time grids.  Returns a dict: price, delta, and d_<param> entries.
    ``device``/``dtype`` as :func:`solve`.
    """
    device = resolve_device(device)
    vals = (kappa, theta, sigma, rho, v0, r, q, T, S0)
    f = dtype or result_dtype(*vals, K)
    leaves = [to_tensor(a, f, device).detach().clone().requires_grad_() for a in vals]
    one = lambda a: a.reshape(1)  # noqa: E731
    call = torch.as_tensor(bool(is_call), device=device).reshape(1)
    with torch.enable_grad():
        res = _solve_core(
            *(one(a) for a in leaves[:8]), one(to_tensor(K, f, device)), call,
            one(leaves[8]), american=american, american_method=american_method,
            n_spot=n_spot, n_vol=n_vol, n_time=n_time, s_min_mult=s_min_mult,
            s_max_mult=s_max_mult, v_max=v_max, remat=remat)
        price = res.price[0]
        grads = torch.autograd.grad(price, leaves)
    names = ("d_kappa", "d_theta", "d_sigma", "d_rho", "d_v0", "d_r", "d_q", "d_T")
    out = {"price": price.detach(), "delta": grads[8]}
    out.update(dict(zip(names, grads[:8])))
    return out


def solve_fused(params: HestonPDEParams, S0, device=None, dtype=None) -> HestonPDEResult:
    """Solve through the fused march K2
    (:func:`~pde_tpu_torch.ops.adi_fused.fused_douglas_march`): the whole
    time loop of one option in one launch on a CUDA device (its plain twin
    on the CPU), in float32, the result cast back to the grid's dtype.
    European and American in both projection and Ikonen-Toivanen modes;
    Douglas scheme only.  ``device``/``dtype`` as :func:`solve`.
    """
    if params.american and params.american_method not in ("projection", "it_lcp"):
        raise ValueError("solve_fused supports american_method 'projection' or "
                         "'it_lcp'")
    if params.scheme != "douglas":
        raise ValueError("the fused kernel implements the Douglas scheme; "
                         "use solve() for craig_sneyd")
    _validate_params(params)
    device = resolve_device(device)
    kappa, theta, sigma, rho, v0, r, q, T, K, S0 = _params_as_tensors(
        params, S0, device, dtype)
    args, (s_grid, v_grid, dx, dv, a1, a2) = _fused_inputs(
        params, kappa, theta, sigma, rho, r, q, T, K)
    nS, nv = params.n_spot, params.n_vol
    V = fused_douglas_march(*args, n_spot=nS, n_vol=nv,
                            n_time=params.n_time).to(s_grid.dtype)
    LV = _apply_a0(V, v_grid, dx, dv, rho, sigma) + _apply_a1(V, *a1) + _apply_a2(V, *a2)
    one = lambda a: a[None]  # noqa: E731
    price, delta, gamma, vega, theta_g = (a[0] for a in _readout(
        one(V), one(s_grid), v_grid, dv, one(S0), one(v0), one(T), one(LV),
        split_davg=False))
    return HestonPDEResult(price, delta, gamma, vega, theta_g, V, s_grid, v_grid)


def _fused_inputs(p: HestonPDEParams, kappa, theta, sigma, rho, r, q, T, K):
    """K2's inputs for one option (0-d tensors of one dtype), in its public
    layout ``(payoff, a1, i1, a2, i2, mix, s_grid, scalars)``, and what the
    readout needs: (s_grid, v_grid, dx, dv, A1 bands, A2 bands)."""
    nS, nv, nT = p.n_spot, p.n_vol, p.n_time
    s_grid = torch.exp(grids.linspace(torch.log(K * p.s_min_mult),
                                      torch.log(K * p.s_max_mult), nS))
    dx = (math.log(p.s_max_mult) - math.log(p.s_min_mult)) / (nS - 1)
    v_grid = grids.linspace(torch.zeros_like(K), torch.full_like(K, p.v_max), nv)
    dv = p.v_max / (nv - 1)
    dt = T / nT
    th = 0.5

    payoff_1d = (torch.clamp_min(s_grid - K, 0.0) if p.is_call
                 else torch.clamp_min(K - s_grid, 0.0))
    payoff = payoff_1d[:, None].expand(nS, nv)
    lo_v, di_v, up_v = _a1_diags(v_grid, dx, r, q)
    a1_lower, a1_diag, a1_upper = _assemble_a1(nS, nv, lo_v, di_v, up_v)
    a2_lower, a2_diag, a2_upper = _a2_diags(v_grid, dv, kappa, theta, sigma, r)

    # row-aligned (nS, nv) layouts: band[i] multiplies the value shifted
    # INTO row i (zero where the shift runs off the grid)
    zrow = torch.zeros((1, nv), dtype=K.dtype, device=K.device)
    row_align = lambda lo, di, up: (torch.cat([zrow, lo.T]), di.T,   # noqa: E731
                                    torch.cat([up.T, zrow]))
    zero = torch.zeros((1,), dtype=K.dtype, device=K.device)
    v_align = lambda lo, di, up: (torch.cat([zero, lo]), di,        # noqa: E731
                                  torch.cat([up, zero]))
    a1b = row_align(a1_lower, a1_diag, a1_upper)
    i1b = row_align(-th * dt * a1_lower, 1.0 - th * dt * a1_diag, -th * dt * a1_upper)
    a2b = v_align(a2_lower, a2_diag, a2_upper)
    i2b = v_align(-th * dt * a2_lower, 1.0 - th * dt * a2_diag, -th * dt * a2_upper)
    mix = (rho * sigma / (4.0 * dx * dv)) * v_grid
    use_it = bool(p.american) and p.american_method == "it_lcp"
    flag = lambda b: torch.full_like(K, float(bool(b)))  # noqa: E731
    scalars = torch.stack([dt, r, q, K, flag(p.is_call), flag(p.american), flag(use_it)])
    return ((payoff, a1b, i1b, a2b, i2b, mix, s_grid, scalars),
            (s_grid, v_grid, dx, dv, (a1_lower, a1_diag, a1_upper),
             (a2_lower, a2_diag, a2_upper)))


def np_any_flag(arr) -> bool:
    """Host-side any() on a flag array: the flag selects a kernel variant,
    so it resolves before the march is launched."""
    if isinstance(arr, torch.Tensor):
        return bool(torch.any(arr > 0.5))
    return bool(np.any(np.asarray(arr) > 0.5))


def _broadcast_batch(kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
                     american, device):
    """Every argument as a float32 (n,) tensor on ``device``."""
    vals = [torch.atleast_1d(torch.as_tensor(a, device=device).to(torch.float32))
            for a in (kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
                      american)]
    n = max(a.shape[0] for a in vals)
    return tuple(a.expand(n).contiguous() for a in vals)


def _march_inputs(kappa, theta, sigma, rho, r, q, T, K, is_call, american,
                  n_spot, n_vol, n_time, s_min_mult, s_max_mult, v_max):
    """The fused march's inputs for a book of (B,) float32 tensors, in the
    kernel's public layout: ``(pay, sg, a1, i1, a2, i2, mix, sc)``, plus the
    shared v grid."""
    nS, nv, nT = n_spot, n_vol, n_time
    B = kappa.shape[0]
    th = 0.5
    f32, dev = torch.float32, kappa.device

    # K-scaled log-spot grid: x = ln(S/K) is SHARED across the batch, so dx
    # (and the S-operator lattice coefficients) are option-independent.
    # Both grids are spaced in float64 and rounded once.
    x = torch.linspace(math.log(s_min_mult), math.log(s_max_mult), nS,
                       dtype=torch.float64, device=dev).to(f32)
    dx = _dx(nS, s_min_mult, s_max_mult)
    ex = torch.exp(x)                                     # (nS,)
    v_grid = torch.linspace(0.0, v_max, nv, dtype=torch.float64, device=dev).to(f32)
    dv = v_max / (nv - 1)
    dt = T / nT                                           # (B,)

    sg = ex[:, None] * K[None, :]                         # (nS, B)
    pay = torch.where(
        is_call[None, :] > 0.5,
        torch.clamp_min(ex - 1.0, 0.0)[:, None] * K[None, :],
        torch.clamp_min(1.0 - ex, 0.0)[:, None] * K[None, :],
    )

    # explicit S-operator interior coefficients, (nv, B)
    a = 0.5 * v_grid[:, None] / (dx * dx)                 # (nv, 1)
    bb = (r - q - 0.5 * v_grid[:, None]) / (2.0 * dx)     # (nv, B)
    a1 = torch.stack([a - bb, -2.0 * a - 0.5 * r[None, :], a + bb])   # (3,nv,B)
    i1 = torch.stack([
        -th * dt[None, :] * a1[0],
        1.0 - th * dt[None, :] * a1[1],
        -th * dt[None, :] * a1[2],
    ])

    # v-operator bands per option, row-aligned
    a2lo, a2di, a2up = _a2_diags(v_grid, dv, kappa[:, None], theta[:, None],
                                 sigma[:, None], r[:, None])  # (B, nv-1/nv/nv-1)

    def v_align(lower, diag, upper):
        zero = torch.zeros((B, 1), dtype=f32, device=dev)
        return torch.stack([torch.cat([zero, lower], 1).T, diag.T,
                            torch.cat([upper, zero], 1).T])

    a2 = v_align(a2lo, a2di, a2up)                        # (3, nv, B)
    i2 = v_align(-th * dt[:, None] * a2lo, 1.0 - th * dt[:, None] * a2di,
                 -th * dt[:, None] * a2up)

    mix = (rho * sigma / (4.0 * dx * dv))[None, :] * v_grid[:, None]  # (nv, B)
    mix[nv - 1, :] = 0.0                                  # j = nv-1 is Dirichlet

    zeros = torch.zeros((B,), dtype=f32, device=dev)
    sc = torch.stack([dt, r, q, K, is_call, american, zeros, zeros])  # (8, B)
    return (pay[:, None, :], sg[:, None, :], a1, i1, a2, i2, mix[None],
            sc[:, None, :]), v_grid


def _dx(nS, s_min_mult, s_max_mult):
    return (math.log(s_max_mult) - math.log(s_min_mult)) / (nS - 1)


def _fused_batch_impl(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0, american,
    use_it, n_spot, n_vol, n_time, s_min_mult, s_max_mult, v_max,
    pcr_v=False, pcr_s=False,
):
    """Build the book's operator bands, march it, read out price and Greeks.
    All inputs are (B,) float32 tensors on one device."""
    nS, nv = n_spot, n_vol
    B = kappa.shape[0]
    with span("pde_tpu_torch.heston_adi.bands"):
        args, v_grid = _march_inputs(kappa, theta, sigma, rho, r, q, T, K, is_call,
                                     american, n_spot, n_vol, n_time, s_min_mult,
                                     s_max_mult, v_max)
    with span("pde_tpu_torch.heston_adi.march"):
        V = fused_douglas_march_batched(*args, n_spot=nS, n_vol=nv, n_time=n_time,
                                        use_it=use_it, pcr_v=pcr_v,
                                        pcr_s=pcr_s)     # (nS, nv, B)
    dx = _dx(nS, s_min_mult, s_max_mult)
    dv = v_max / (nv - 1)

    # price + Greeks per option on its own grid (as the reference's
    # heston_pde.hpp:481-559); theta from the PDE: V_t = -(A0 + A1 + A2) V
    with span("pde_tpu_torch.heston_adi.readout"):
        Vt = V.permute(2, 0, 1)                           # (B, nS, nv)
        sgT = args[1][:, 0, :].T.contiguous()             # (B, nS)
        lo_v, di_v, up_v = _a1_diags(v_grid, dx, r[:, None], q[:, None])
        a1l, a1d, a1u = _assemble_a1(nS, nv, lo_v, di_v, up_v)
        a2l, a2d, a2u = _a2_diags(v_grid, dv, kappa[:, None], theta[:, None],
                                  sigma[:, None], r[:, None])
        LV = (_apply_a0(Vt, v_grid, dx, dv, rho[:, None, None], sigma[:, None, None])
              + _apply_a1(Vt, a1l, a1d, a1u) + _apply_a2(Vt, a2l, a2d, a2u))
        greeks = _readout(Vt, sgT, v_grid, dv, S0, v0, T, LV, split_davg=False)
    return HestonPDEResult(*greeks, Vt, sgT, v_grid.expand(B, nv))


def solve_fused_batch(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
    american=False,
    american_method: str = "projection",
    n_spot: int = 100,
    n_vol: int = 50,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    v_max: float = 1.0,
    pcr_v: bool = False,
    pcr_s: bool = False,
    device=None,
) -> HestonPDEResult:
    """Batch PDE pricing through the fused Douglas march.

    Every array argument broadcasts along one leading batch axis, and
    ``is_call`` and ``american`` are per-option: a book may mix strikes,
    maturities, rates, Heston parameters, calls and puts, European and
    American.  ``american_method`` selects the projection or the
    Ikonen-Toivanen treatment for the flagged options.  The book marches on
    ``device`` (default: the CUDA card; ``device="cpu"`` runs the plain
    march) in float32; on a CUDA device the march is one kernel launch.

    Greeks: delta/gamma/vega/theta from the grid (heston_pde.hpp:520-559).
    ``pcr_v``/``pcr_s`` replace the serial Thomas v/S sweep with parallel
    cyclic reduction (level coefficients precomputed once; ~1e-5 relative
    from the Thomas march in float32).
    """
    if american_method not in ("projection", "it_lcp"):
        raise ValueError(
            "solve_fused_batch supports american_method 'projection' or "
            "'it_lcp'"
        )
    with span("pde_tpu_torch.heston_adi.solve_fused_batch"):
        device = resolve_device(device)
        # the kernel variant resolves from the CALLER's american argument, so
        # both packages pick the same variant for the same inputs
        use_it = american_method == "it_lcp" and np_any_flag(american)
        args = _broadcast_batch(kappa, theta, sigma, rho, v0, r, q, T, K, is_call,
                                S0, american, device)
        return _fused_batch_impl(
            *args, use_it, n_spot, n_vol, n_time, s_min_mult, s_max_mult, v_max,
            pcr_v, pcr_s,
        )
