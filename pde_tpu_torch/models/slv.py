"""Stochastic-local volatility: Heston dynamics times a Dupire leverage
(twin of ``pde_tpu/models/slv.py``).

    dS/S = (r - q) dt + L(S, t) sqrt(v) dW_S
    dv   = kappa (theta - v) dt + sigma sqrt(v) dW_v,  d<W_S,W_v> = rho dt

with the leverage L chosen so vanillas match a target local-vol surface.
Gyongy's condition L^2(s, t) E[v_t | S_t = s] = sigma_loc^2(s, t) is solved
in one forward sweep by the particle method (Guyon & Henry-Labordere
2012): march a particle cloud, estimate E[v | S] at each step by binning,
set L from the target surface, step with it.

The spot update splits the Andersen QE coefficients into their rho-coupled
part (one power of L) and the variance compensator (L^2), and Andersen's
K0* martingale correction becomes a per-particle correction, so the
discounted spot is a discrete martingale for any leverage; at L = 1 the
step is the QE step of :mod:`pde_tpu_torch.models.heston_mc`.

**Binning.**  The reference's ``segment_sum`` over bins becomes one
full-float32 product of the particles' one-hot bin matrix ``(P, n_bins)``
with ``(1, v)``: the counts are exact, and the sums add in a fixed order,
so a run repeats bit for bit on the card (a float32 ``index_add_`` there
adds in atomic order, which moves the sums by ulps from run to run).

**Draws.**  Where the reference takes a PRNG key, each name takes a
``torch.Generator`` on the path's device or a replay
(:mod:`pde_tpu_torch.models.heston_mc`), split into ``n_steps`` step
sources and each into ``(u, z)``, as the reference splits its key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.precision import device_of, result_dtype, to_tensor
from .heston import HestonParams
from .heston_mc import _TINY, PSI_CRIT, MCPaths, _draws, _qe_constants, _qe_variance_draw
from .rates import _linspace

__all__ = [
    "LeverageSurface",
    "calibrate_leverage",
    "simulate_slv",
    "slv_simulate_fn",
]


class LeverageSurface(NamedTuple):
    """Calibrated leverage on a fixed (time-step, ln-spot-bin) grid."""

    ln_s_centers: torch.Tensor   # (n_bins,)
    times: torch.Tensor          # (n_steps,) left endpoints t_k
    values: torch.Tensor         # (n_steps, n_bins)


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for increasing ``xp``: linear between the
    knots and flat beyond both ends, the knot found by ``searchsorted``
    on the right and clamped to [1, n - 1], as ``rates._plan_reads``
    reads a curve."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.shape[0] - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    f = f0 + ((x - x0) / (xp[i] - x0)) * (fp[i] - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _slv_coeffs(params: HestonParams, dt, dtype):
    """QE spot-update coefficients split by leverage power:

        ln S' = ln S + (r-q) dt
                + L   * (k0r + k1r v + k2r v')
                + L^2 * (k1v v + k2v v')
                + L   * sqrt(k3 v + k4 v') Z

    At L = 1 this is Andersen's central scheme."""
    kappa, theta, sigma, rho = (to_tensor(getattr(params, f), dtype, dt.device)
                                for f in ("kappa", "theta", "sigma", "rho"))
    g1 = g2 = 0.5
    k0r = -rho * kappa * theta * dt / sigma
    k1r = g1 * dt * kappa * rho / sigma - rho / sigma
    k2r = g2 * dt * kappa * rho / sigma + rho / sigma
    k1v = -0.5 * g1 * dt
    k2v = -0.5 * g2 * dt
    k3 = g1 * dt * (1.0 - rho * rho)
    k4 = g2 * dt * (1.0 - rho * rho)
    return k0r, k1r, k2r, k1v, k2v, k3, k4


def _k0_star_leveraged(v, a, b2, p, beta, is_quad, A, B):
    """Andersen's K0* with per-particle effective coefficients: A the
    coefficient of v' in the moment-generating exponent (L k2r + L^2 (k2v +
    k4/2)), B that of v (L k1r + L^2 (k1v + k3/2)); the branch algebra only
    sees A, so martingality holds per particle for any leverage."""
    one_m2Aa = torch.clamp_min(1.0 - 2.0 * A * a, _TINY)
    k0_quad = -A * b2 * a / one_m2Aa + 0.5 * torch.log(one_m2Aa)
    beta_mA = torch.clamp_min(beta - A, _TINY)
    k0_exp = -torch.log(torch.clamp_min(p + beta * (1.0 - p) / beta_mA, _TINY))
    return torch.where(is_quad, k0_quad, k0_exp) - B * v


def _make_slv_step(params, dt, n_draw, antithetic, dtype, drift):
    """``(ln_s, v, L_particles, source) -> (ln_s', v')`` with the exact
    per-particle martingale correction."""
    device = dt.device
    E, c1, c2, _k0, _k1, _k2, _k3, _k4 = _qe_constants(params, dt, dtype)
    theta = to_tensor(params.theta, dtype, device)
    k0r, k1r, k2r, k1v, k2v, k3, k4 = _slv_coeffs(params, dt, dtype)

    def step(ln_s, v, L, k_t):
        k_u, k_z = k_t.split(2)
        u = k_u.uniform((n_draw,), dtype, device)
        z = k_z.normal((n_draw,), dtype, device)
        if antithetic:
            u = torch.cat([u, 1.0 - u])
            z = torch.cat([z, -z])
        v_new, a, b2, p, beta, is_quad = _qe_variance_draw(v, u, E, c1, c2, theta, PSI_CRIT,
                                                           dtype)
        L2 = L * L
        A = L * k2r + L2 * (k2v + 0.5 * k4)
        B = L * k1r + L2 * (k1v + 0.5 * k3)
        k0 = _k0_star_leveraged(v, a, b2, p, beta, is_quad, A, B)
        vol = L * torch.sqrt(torch.clamp_min(k3 * v + k4 * v_new, 0.0))
        ln_s_new = (ln_s + drift + k0 + L * (k1r * v + k2r * v_new)
                    + L2 * (k1v * v + k2v * v_new) + vol * z)
        return ln_s_new, v_new

    return step


def _bin_expectation(ln_s, v, edges, n_bins, min_count=8, axis_name=None):
    """E[v | S in bin] by binned means; a bin with fewer than ``min_count``
    particles takes the global mean.  Returns ``(ev, idx)``.

    The bin of a particle is ``searchsorted(edges, ln_s)`` on the left,
    less one, clamped to [0, n_bins - 1] (a particle exactly on an edge
    falls in the bin below it, as in the reference).  The counts and sums
    are one full-float32 product of the one-hot bin matrix with ``(1, v)``
    (exact counts; a fixed order of addition).  With ``axis_name`` (a path
    axis sharded over the ranks of that dimension of the mesh in use,
    ``parallel.using_mesh``) the counts, sums and the cloud's total are
    ``all_reduce``d in one collective, so every rank sees the GLOBAL
    conditional expectation (``parallel/mc.calibrate_leverage_sharded``)."""
    from ..calibrate.lm import _full_fp32_matmul  # calibrate imports the models

    idx = torch.clamp(torch.searchsorted(edges, ln_s.contiguous()) - 1, 0, n_bins - 1)
    one_hot = (idx[:, None] == torch.arange(n_bins, device=idx.device)).to(v.dtype)
    with _full_fp32_matmul():
        counts, sums = torch.stack([torch.ones_like(v), v]) @ one_hot
    v_sum = torch.sum(v)
    n_tot = torch.full((), float(v.shape[0]), dtype=v.dtype, device=v.device)
    if axis_name is not None:
        from ..parallel.mesh import psum

        tot = psum(torch.cat([counts, sums, torch.stack([v_sum, n_tot])]), axis_name)
        counts, sums, v_sum, n_tot = (tot[:n_bins], tot[n_bins:2 * n_bins], tot[-2],
                                      tot[-1])
    ev = sums / torch.clamp_min(counts, 1.0)
    return torch.where(counts >= min_count, ev, v_sum / n_tot), idx


def _state0(s0, v0, n_paths):
    """log-spot, variance, running sum, max and min of the cloud at t_0."""
    return (torch.log(s0).expand(n_paths), v0.expand(n_paths), torch.zeros_like(
        s0.expand(n_paths)), s0.expand(n_paths), s0.expand(n_paths))


def _advance(state, step, L, k_t):
    """One leveraged step of the cloud, with its running statistics."""
    ln_s, v, s_sum, s_max, s_min = state
    ln_s, v = step(ln_s, v, L, k_t)
    s = torch.exp(ln_s)
    return ln_s, v, s_sum + s, torch.maximum(s_max, s), torch.minimum(s_min, s)


def _paths(state, n_steps):
    ln_s, v, s_sum, s_max, s_min = state
    return MCPaths(torch.exp(ln_s), v, s_sum / n_steps, s_max, s_min)


def _prelude(params, spot, maturity, generator, n_paths, rate, dividend, antithetic,
             device):
    """dtype, device, draw source, T, s0, v0, the per-path draw count and
    (r - q) as tensors."""
    dtype = result_dtype(spot, maturity, params.kappa)
    device = device_of(spot, maturity, *params, default=device)
    source = _draws(generator, device)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths
    T = to_tensor(maturity, dtype, device)
    r_q = to_tensor(rate, dtype, device) - to_tensor(dividend, dtype, device)
    return (dtype, device, source, T, to_tensor(spot, dtype, device),
            to_tensor(params.v0, dtype, device), n_draw, r_q)


def calibrate_leverage(
    params: HestonParams,
    vol_fn,
    spot,
    maturity,
    generator,
    *,
    n_steps: int = 48,
    n_paths: int = 65536,
    n_bins: int = 31,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    span_sigmas: float = 4.5,
    l_min: float = 0.05,
    l_max: float = 20.0,
    axis_name: str | None = None,
    device=None,
):
    """One-sweep particle calibration of the leverage to the target local
    vol ``vol_fn(s, t) -> sigma_loc`` (e.g. a
    :class:`~pde_tpu_torch.models.local_vol.SurfaceInterpolator`).

    Returns ``(LeverageSurface, MCPaths)``: the sweep is itself a
    simulation under the calibrated model.  The bins span ``span_sigmas``
    standard deviations of the log-spot around its forward; the target is
    read at each step's midpoint time; the leverage is clamped to [l_min,
    l_max] and interpolated to each particle (flat beyond the end bins).
    Runs on the first tensor's device among spot, maturity and the
    parameters, else on ``device``, else on the card.
    """
    dtype, device, source, T, s0, v0, n_draw, r_q = _prelude(
        params, spot, maturity, generator, n_paths, rate, dividend, antithetic, device)
    dt = T / n_steps
    vbar = torch.maximum(to_tensor(params.theta, dtype, device), v0)
    half_span = span_sigmas * torch.sqrt(vbar * T)
    center = torch.log(s0) + 0.5 * r_q * T
    edges = _linspace(center - half_span, center + half_span, n_bins + 1, dtype, device)
    centers = 0.5 * (edges[1:] + edges[:-1])
    s_centers = torch.exp(centers)
    step = _make_slv_step(params, dt, n_draw, antithetic, dtype, r_q * dt)
    times = dt * torch.arange(n_steps, dtype=dtype, device=device)

    state = _state0(s0, v0, n_paths)
    rows = []
    for t_k, k_t in zip(times, source.split(n_steps)):
        ev, _ = _bin_expectation(state[0], state[1], edges, n_bins, axis_name=axis_name)
        # the target at the step's midpoint time (less discretization bias
        # than the left point in the reference's mixed-dynamics check)
        sig_loc = vol_fn(s_centers, t_k + 0.5 * dt)
        L_bins = torch.clamp(sig_loc / torch.sqrt(torch.clamp_min(ev, _TINY)), l_min, l_max)
        state = _advance(state, step, _interp(state[0], centers, L_bins), k_t)
        rows.append(L_bins)
    return LeverageSurface(centers, times, torch.stack(rows)), _paths(state, n_steps)


def simulate_slv(
    params: HestonParams,
    leverage: LeverageSurface,
    spot,
    maturity,
    generator,
    *,
    n_steps: int | None = None,
    n_paths: int = 65536,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    device=None,
):
    """Re-simulate under a frozen calibrated leverage surface (fresh draws):
    the pricing pass for exotics.  ``n_steps`` must match the calibration
    grid (one leverage row a step) and defaults to it; the surface is read
    in the path's dtype on the path's device."""
    rows = leverage.values.shape[0]
    if n_steps is None:
        n_steps = rows
    if n_steps != rows:
        raise ValueError(f"n_steps={n_steps} != calibrated rows={rows}")
    dtype, device, source, T, s0, v0, n_draw, r_q = _prelude(
        params, spot, maturity, generator, n_paths, rate, dividend, antithetic, device)
    dt = T / n_steps
    step = _make_slv_step(params, dt, n_draw, antithetic, dtype, r_q * dt)
    centers, values = (a.to(device=device, dtype=dtype)
                       for a in (leverage.ln_s_centers, leverage.values))
    state = _state0(s0, v0, n_paths)
    for L_bins, k_t in zip(values, source.split(n_steps)):
        state = _advance(state, step, _interp(state[0], centers, L_bins), k_t)
    return _paths(state, n_steps)


def slv_simulate_fn(leverage: LeverageSurface):
    """Adapter: a drop-in ``simulate_fn`` for the
    :mod:`pde_tpu_torch.models.heston_mc` estimators, which then price
    under the calibrated SLV dynamics (the parameter record passes
    through; ``n_steps`` is pinned to the calibration grid)."""
    def fn(params, spot, maturity, generator, **kwargs):
        kwargs.pop("n_steps", None)
        return simulate_slv(params, leverage, spot, maturity, generator, **kwargs)
    return fn
