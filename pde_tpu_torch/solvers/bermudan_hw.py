"""Bermudan swaptions under Hull-White: a PDE march and an exact-transition
LSM / Andersen-Broadie Monte Carlo sandwich, each cross-validating the
other (twin of ``pde_tpu/solvers/bermudan_hw.py``).

* **PDE** (:func:`bermudan_swaption_pde`).  With ``r(t) = x(t) +
  alpha(t)`` the factor ``x`` is the OU process ``dx = -a x dt + sigma
  dW``, so the pricing PDE on an x-grid,

      V_t + (1/2) sigma^2 V_xx - a x V_x - (x + alpha(t)) V = 0,

  is a constant-stencil theta-scheme march whose only time dependence is
  the scalar ``alpha(t)`` on the reaction term.  Exercise dates project
  onto the closed-form remaining-swap value; the boundary rows drop the
  diffusion and upwind the inward convection, keeping the system
  tridiagonal; two implicit Rannacher steps follow every projection.
  A strike vector marches as one batch: the bands do not depend on the
  strike, so each step is ONE tridiagonal solve of ``(n_strikes, n_x)``
  systems with the bands shared (batch stride 0).  On the card in float32
  outside autograd that solve is one launch of the batched Thomas kernel
  (``ops/tridiag.thomas_batched``, K5) on its lane-group route, which
  reads the shared bands in place; float64, the CPU and autograd take the
  differentiable ``thomas`` (:func:`~pde_tpu_torch.ops.tridiag.kernel_route`).
  A failed build or launch raises.

* **Monte Carlo** (:func:`bermudan_swaption_mc`).  ``(x(t), int x ds)`` is
  jointly Gaussian with closed-form moments, so paths step from exercise
  date to exercise date with no discretization bias, and the
  deterministic part of the discount is the closed-form ``int alpha``.
  Longstaff-Schwartz on an x-polynomial basis gives the frozen policy; an
  out-of-sample re-simulation gives the lower bound; nested exact
  sub-simulations give the Andersen-Broadie dual upper bound.  Each
  regression solves its 4x4 normal equations by ``solve_ex``, read once
  after the march (:mod:`pde_tpu_torch.solvers.lsm`'s rule: NaN
  coefficients where a solve fails on a date with no path in the money,
  an error where paths are in the money).  The products run in full
  float32 (TF32 off).

**Draws.**  Where the reference takes a PRNG key, the Monte Carlo names
take a ``torch.Generator`` on the curve's device or a replay
(:mod:`pde_tpu_torch.models.heston_mc`), split as the reference splits its
key: ``(reg, outer, inner)``, one source per event step, and a chain of
``(next, draw)`` pairs in the continuation.  Everything runs on the
curve's device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..calibrate.lm import _full_fp32_matmul
from ..core.precision import device_of, result_dtype, to_tensor
from ..models import rates
from ..models.heston_mc import _draws
from ..models.rates import HullWhiteParams, _host_floats, _linspace, _on
from ..ops.tridiag import kernel_route, tridiagonal_solve
from .lsm import _solve, _solved

__all__ = [
    "remaining_swap_value",
    "bermudan_swaption_pde",
    "bermudan_swaption_mc",
    "hw_joint_increment_moments",
    "hw_alpha_integral",
]


# ---------------------------------------------------------------------------
# closed-form building blocks


def hw_alpha_integral(params: HullWhiteParams, t1, t2):
    """``int_{t1}^{t2} alpha(s) ds`` in closed form: the forward part is
    ``log(P(0,t1)/P(0,t2))``, the variance part elementary.  Broadcasts
    over ``t1``/``t2``."""
    t1, t2, a, sig = _on(params.curve, t1, t2, params.a, params.sigma)
    fwd_part = torch.log(params.curve.df(t1) / params.curve.df(t2))
    e1, e2 = torch.exp(-a * t1), torch.exp(-a * t2)
    var_part = (sig * sig / (2.0 * a * a)) * (
        (t2 - t1) + (2.0 / a) * (e2 - e1) - (1.0 / (2.0 * a)) * (e2 * e2 - e1 * e1))
    return fwd_part + var_part


def hw_joint_increment_moments(params: HullWhiteParams, dt):
    """Moments of the exact joint OU increment over a step ``dt``: for
    ``x' = x(t+dt)`` and ``y = int_t^{t+dt} x ds`` given ``x(t) = x``,

        x' | x ~ N(x e^{-a dt}, v_x),  y | x ~ N(x B(dt), v_y),  Cov = c,

    ``B(dt) = (1 - e^{-a dt})/a``.  Returns ``(e, B, v_x, v_y, c)``."""
    dt, a, sig = _on(params.curve, dt, params.a, params.sigma)
    e = torch.exp(-a * dt)
    e2 = e * e
    B = (1.0 - e) / a
    v_x = sig * sig * (1.0 - e2) / (2.0 * a)
    c = (sig * sig / a) * (B - (1.0 - e2) / (2.0 * a))
    v_y = (sig * sig / (a * a)) * (dt - 2.0 * B + (1.0 - e2) / (2.0 * a))
    return e, B, v_x, v_y, c


def remaining_swap_value(params: HullWhiteParams, strike_rate, schedule, j, x, payer=True):
    """Value at schedule date ``T_j`` (short rate ``r = x + alpha(T_j)``) of
    entering the REMAINING swap: the fixed leg pays ``tau_i K`` at
    ``T_{j+1}..T_M``, the float leg is worth par, so payer = 1 - sum_i c_i
    P(T_j, T_i), c_i = tau_i K (+1 at T_M).  ``j`` is an int; the strike
    and ``x`` broadcast together (a strike column ``(S, 1)`` against an
    x-grid ``(n_x,)`` gives ``(S, n_x)``)."""
    schedule, k, x = _on(params.curve, schedule, strike_rate, x)
    taus = torch.diff(schedule)
    pay = schedule[j + 1:]
    coupons = taus[j:] * k[..., None]
    coupons = torch.cat([coupons[..., :-1], coupons[..., -1:] + 1.0], -1)
    t_j = schedule[j]
    r = x[..., None] + _alpha_at(params, t_j)
    bonds = rates.hw_bond(params, pay, t_j, r)  # (..., M-j)
    val = 1.0 - torch.sum(coupons * bonds, dim=-1)
    return val if payer else -val


def _alpha_at(params: HullWhiteParams, t):
    return rates.hw_alpha(params, t)


def _schedule_and_exercise(params, schedule, exercise):
    """The schedule on the curve's device in the result dtype, and the
    exercise flags (default: every date but the last)."""
    dtype = result_dtype(params.curve.dfs, schedule, params.sigma)
    schedule = to_tensor(schedule, dtype, params.curve.dfs.device)
    m = int(schedule.shape[0]) - 1
    if exercise is None:
        exercise = (True,) * m
    exercise = tuple(bool(b) for b in exercise)
    if len(exercise) != m or not any(exercise):
        raise ValueError("exercise must flag at least one of the M dates")
    return schedule, exercise


# ---------------------------------------------------------------------------
# PDE route


def _march_plan(schedule, exercise, n_sub, dtype, device=None):
    """The backward march over the event structure, planned on the host
    from the schedule's values.

    The option dies after its LAST exercisable date T_last, so the march
    starts there with ``V = max(swap, 0)`` and walks down to 0 through each
    earlier date, ``n_sub`` steps an interval.  Returns per-step tensors in
    march order, ``dt``, ``t_mid`` (where alpha is sampled) and the theta
    weight (1 for the two implicit Rannacher steps after each projection,
    else 1/2), the index of the date whose projection follows each step
    (-1 for none, a tuple of ints), and ``last``.
    """
    sched = _host_floats(schedule)
    last = max(j for j, b in enumerate(exercise) if b)
    dts, mids, ws, ev_after = [], [], [], []
    t_hi = sched[last]
    for j in range(last - 1, -2, -1):
        t_lo = sched[j] if j >= 0 else 0.0
        dt = (t_hi - t_lo) / n_sub
        for k in range(n_sub):
            a, b = t_hi - k * dt, t_hi - (k + 1) * dt
            dts.append(dt)
            mids.append(0.5 * (a + b))
            ws.append(1.0 if k < 2 else 0.5)
            ev_after.append(j if (k == n_sub - 1 and j >= 0) else -1)
        t_hi = t_lo
    device = device_of(schedule, default=device)
    return (to_tensor(dts, dtype, device), to_tensor(mids, dtype, device),
            to_tensor(ws, dtype, device), tuple(ev_after), last)


def _bermudan_pde_impl(params, strike_rate, schedule, dts, mids, ws, ev_after, *, payer,
                       n_x, last, exercise):
    """The march for a strike scalar or vector ``(S,)``: ``(price, x,
    V)`` with ``price`` shaped like the strike and ``V`` its shape plus
    ``(n_x,)``."""
    dtype, device = schedule.dtype, schedule.device
    a, sig = (to_tensor(v, dtype, device) for v in (params.a, params.sigma))
    k = to_tensor(strike_rate, dtype, device)
    k_col = k.reshape(-1, 1)  # (S, 1): one march row a strike
    T_last_ex = schedule[last]

    # x-grid: symmetric, holding 0; it covers the OU law at the last
    # exercise date (stationary-capped) with a wide safety factor
    sd = sig * torch.sqrt((1.0 - torch.exp(-2.0 * a * T_last_ex)) / (2.0 * a))
    x_max = 8.0 * torch.clamp_min(sd, 1e-4)
    x = _linspace(-x_max, x_max, n_x, dtype, device)
    dx = x[1] - x[0]
    alphas = _alpha_at(params, mids)

    # intrinsic at each candidate date (rows j = 0..last); a date that does
    # not exercise gets -inf, so its projection is a no-op
    def intrinsic_row(j):
        v = torch.clamp_min(remaining_swap_value(params, k_col, schedule, j, x, payer), 0.0)
        return v if exercise[j] else torch.full_like(v, -torch.inf)

    intr = [intrinsic_row(j) for j in range(last + 1)]  # each (S, n_x)

    # the constant-stencil interior operator: the x-independent diffusion
    # and the x-linear convection and reaction
    diff = 0.5 * sig * sig / (dx * dx)
    conv = -a * x / (2.0 * dx)
    lo_row = diff - conv  # L[i, i-1]
    up_row = diff + conv  # L[i, i+1]
    di_row = -2.0 * diff - x  # L[i, i] less alpha(t)
    # boundary rows: no diffusion, the inward convection upwinded
    zero = x.new_zeros(1)
    lo_row = torch.cat([zero, lo_row[1:-1], (a * x[-1] / dx).reshape(1)])
    up_row = torch.cat([(-a * x[0] / dx).reshape(1), up_row[1:-1], zero])
    di_row = torch.cat([(a * x[0] / dx - x[0]).reshape(1), di_row[1:-1],
                        (-a * x[-1] / dx - x[-1]).reshape(1)])

    # every step's bands at once, (n_t, n_x - 1) / (n_t, n_x): they do not
    # depend on the strike, and each step hands one row of them to the solve
    wdt = (ws * dts)[:, None]
    lo_all = -wdt * lo_row[1:]
    di_all = 1.0 - wdt * (di_row - alphas[:, None])
    up_all = -wdt * up_row[:-1]
    ex_dt = ((1.0 - ws) * dts)[:, None]

    def apply_L(V, alpha):
        Vm = torch.cat([torch.zeros_like(V[..., :1]), V[..., :-1]], -1)
        Vp = torch.cat([V[..., 1:], torch.zeros_like(V[..., :1])], -1)
        return lo_row * Vm + (di_row - alpha) * V + up_row * Vp

    V = torch.clamp_min(remaining_swap_value(params, k_col, schedule, last, x, payer), 0.0)
    S = V.shape[0]
    on_kernel = kernel_route(V, lo_all, di_all, up_all)
    for n, ev in enumerate(ev_after):
        rhs = V + ex_dt[n] * apply_L(V, alphas[n])
        V = tridiagonal_solve(lo_all[n].expand(S, n_x - 1), di_all[n].expand(S, n_x),
                              up_all[n].expand(S, n_x - 1), rhs, use_kernel=on_kernel)
        if ev >= 0:
            V = torch.maximum(V, intr[ev])  # -inf rows: no-op
    i0 = (n_x - 1) // 2  # x = 0 exactly (n_x odd)
    V = V.reshape(k.shape + (n_x,))
    return V[..., i0], x, V


def bermudan_swaption_pde(
    params: HullWhiteParams,
    strike_rate,
    schedule,
    *,
    payer: bool = True,
    exercise: Tuple[bool, ...] | None = None,
    n_x: int = 401,
    n_sub: int = 24,
):
    """Bermudan payer/receiver swaption on the swap with date ``schedule``
    (T_0..T_M; the fixed leg pays at T_1..T_M), exercisable into the
    remaining swap at each ``schedule[j]`` with ``exercise[j]`` true
    (default: all of T_0..T_{M-1}).

    ``strike_rate`` is a number or a strike vector ``(S,)``: a vector
    marches as one batch of ``(S, n_x)`` systems (on the card, one K5
    launch a step).  Returns ``(price, x_grid, value_on_grid)``, the price
    the t = 0 value at ``x = 0`` (``r_0 = f(0, 0)``), shaped like the
    strike, the values with a trailing ``(n_x,)``.  Runs on the curve's
    device.
    """
    schedule, exercise = _schedule_and_exercise(params, schedule, exercise)
    if n_x % 2 == 0:
        raise ValueError("n_x must be odd so x = 0 is on the grid")
    dts, mids, ws, ev_after, last = _march_plan(schedule, exercise, n_sub, schedule.dtype)
    return _bermudan_pde_impl(params, to_tensor(strike_rate, schedule.dtype, schedule.device),
                              schedule, dts, mids, ws, ev_after, payer=payer, n_x=n_x,
                              last=last, exercise=exercise)


# ---------------------------------------------------------------------------
# Monte Carlo route: exact transitions + LSM + Andersen-Broadie dual


def _mc_basis(x):
    """Polynomial regression basis in the single Gaussian factor."""
    return torch.stack([torch.ones_like(x), x, x * x, x * x * x], dim=-1)


def _event_steps(params, ts):
    """Per-step constants of the exact transition between the dates ``ts``
    (0 first): ``(e, B, sd_x, c / sd_x, sd_y, int alpha)``, each ``(n,)``."""
    dts = torch.diff(ts)
    e, B, v_x, v_y, c = hw_joint_increment_moments(params, dts)
    da = hw_alpha_integral(params, ts[:-1], ts[1:])
    sd_x = torch.sqrt(v_x)
    c_over = c / torch.clamp_min(sd_x, 1e-30)
    sd_y = torch.sqrt(torch.clamp_min(v_y - c_over * c_over, 0.0))
    return e, B, sd_x, c_over, sd_y, da


def _transition(xv, logd, consts, k_t):
    """One exact step of ``(x, -int r)`` on a ``(2,) + x.shape`` normal
    draw of ``k_t``."""
    e_t, B_t, sx, co, sy, da_t = consts
    z = k_t.normal((2,) + tuple(xv.shape), xv.dtype, xv.device)
    x_new = xv * e_t + sx * z[0]
    y = xv * B_t + co * z[0] + sy * z[1]
    return x_new, logd - da_t - y


def _simulate_events(params, schedule, exercise_idx, n_paths, generator, dtype):
    """Exact path panel at the dates ``schedule[exercise_idx]``: ``(xs,
    log_ds)`` of shape (n_ex, n_paths), the factor and the cumulative log
    discount ``-int_0^{T_j} r ds``, both exact in distribution; one draw
    source a step, split from ``generator`` as the reference splits its
    key."""
    device = schedule.device
    idx = torch.as_tensor(exercise_idx, device=device)
    ts = torch.cat([torch.zeros(1, dtype=dtype, device=device), schedule[idx].to(dtype)])
    steps = _event_steps(params, ts)
    source = _draws(generator, device)
    xv = torch.zeros(n_paths, dtype=dtype, device=device)
    logd = torch.zeros(n_paths, dtype=dtype, device=device)
    xs, log_ds = [], []
    for n, k_t in enumerate(source.split(ts.shape[0] - 1)):
        xv, logd = _transition(xv, logd, [s[n] for s in steps], k_t)
        xs.append(xv)
        log_ds.append(logd)
    return torch.stack(xs), torch.stack(log_ds)


def _bermudan_mc_impl(params, strike_rate, schedule, generator, *, payer, exercise, n_paths,
                      n_outer, n_inner):
    dtype, device = schedule.dtype, schedule.device
    ex_idx = tuple(j for j, b in enumerate(exercise) if b)
    n_ex = len(ex_idx)
    source = _draws(generator, device)
    ts = torch.cat([torch.zeros(1, dtype=dtype, device=device),
                    schedule[torch.as_tensor(ex_idx, device=device)]])
    steps = _event_steps(params, ts)  # row r: the step into exercise row r

    def payoff_at(row, x):
        """Discount-free exercise value at exercise row ``row``."""
        return torch.clamp_min(
            remaining_swap_value(params, strike_rate, schedule, ex_idx[row], x, payer), 0.0)

    k_reg, k_out, k_in = source.split(3)
    with _full_fp32_matmul():
        # -- phase 1: regression pass -> frozen policy -------------------
        # each path's cashflow divided by ITS OWN discount to T_j, so the
        # regressand's conditional mean given x_j is the continuation value
        # (x is Markov) and the policy is a pure state rule
        xs, log_ds = _simulate_events(params, schedule, ex_idx, n_paths, k_reg, dtype)
        ds = torch.exp(log_ds)  # (n_ex, P) discounts to 0
        pay = torch.stack([payoff_at(j, xs[j]) for j in range(n_ex)])
        cash = ds[-1] * pay[-1]
        eye = torch.eye(4, dtype=dtype, device=device)
        gammas, failures = [], []
        for j in range(n_ex - 2, -1, -1):
            phi = _mc_basis(xs[j])
            w = (pay[j] > 0.0).to(dtype)
            gram = (phi * w[:, None]).T @ phi + 1e-10 * eye
            rhs = (phi * w[:, None]).T @ (cash / ds[j])
            beta = _solve(gram, rhs, torch.sum(w), failures)
            cont = phi @ beta  # C_j estimate, T_j units
            ex = (pay[j] > 0.0) & (pay[j] > cont)
            cash = torch.where(ex, ds[j] * pay[j], cash)
            gammas.append(beta)
        _solved(failures)
        gammas = torch.stack(gammas[::-1] + [torch.zeros(4, dtype=dtype, device=device)])

        def policy_stops(row, x):
            """The frozen state rule at exercise row ``row``: payoff against
            fitted continuation, both in T_row units."""
            if row == n_ex - 1:
                return torch.ones(x.shape, dtype=torch.bool, device=device)
            hv = payoff_at(row, x)
            cont = _mc_basis(x) @ gammas[row]
            return (hv > 0.0) & (hv > cont)

        def continuation(start, x0, log_d0, k_t):
            """Discounted-to-0 payoff of continuing the frozen policy from
            exercise row ``start`` (-1: time 0)."""
            val = torch.zeros_like(x0)
            active = torch.ones(x0.shape, dtype=torch.bool, device=device)
            xv, logd = x0, log_d0
            for row in range(start + 1, n_ex):
                k_t, k_u = k_t.split(2)
                xv, logd = _transition(xv, logd, [s[row] for s in steps], k_u)
                stop = active & policy_stops(row, xv)
                val = val + torch.where(stop, torch.exp(logd) * payoff_at(row, xv), 0.0)
                active = active & ~stop
            return val

        # -- phase 2: out-of-sample lower bound --------------------------
        n0 = n_outer * n_inner
        k0, k_in = k_in.split(2)
        zeros = torch.zeros(n0, dtype=dtype, device=device)
        val0 = continuation(-1, zeros, zeros, k0)
        lower = torch.mean(val0)
        se_lower = torch.std(val0, correction=0) / (1.0 * n0) ** 0.5

        # -- phase 3: Andersen-Broadie dual ------------------------------
        xs_o, logd_o = _simulate_events(params, schedule, ex_idx, n_outer, k_out, dtype)
        h_o = torch.stack([payoff_at(j, xs_o[j]) for j in range(n_ex)]) * torch.exp(logd_o)
        m = torch.zeros(n_outer, dtype=dtype, device=device)
        g_max = torch.full((n_outer,), -torch.inf, dtype=dtype, device=device)
        c_prev = lower  # C_0, from the same bundle
        for row in range(n_ex):
            if row < n_ex - 1:
                k_row, k_in = k_in.split(2)
                # the output size given: no host read
                x_rep, d_rep = (torch.repeat_interleave(a[row], n_inner, output_size=n0)
                                for a in (xs_o, logd_o))
                c_here = torch.mean(continuation(row, x_rep, d_rep, k_row).reshape(
                    n_outer, n_inner), dim=1)
                v_hat = torch.where(policy_stops(row, xs_o[row]), h_o[row], c_here)
            else:
                v_hat = h_o[row]
                c_here = torch.zeros_like(v_hat)
            m = m + (v_hat - c_prev)
            g_max = torch.maximum(g_max, h_o[row] - m)
            c_prev = c_here
        g_pos = torch.clamp_min(g_max, 0.0)
        upper = torch.mean(g_pos)
        se_upper = torch.std(g_pos, correction=0) / (1.0 * n_outer) ** 0.5
    return lower, se_lower, upper, se_upper


def bermudan_swaption_mc(
    params: HullWhiteParams,
    strike_rate,
    schedule,
    generator,
    *,
    payer: bool = True,
    exercise: Tuple[bool, ...] | None = None,
    n_paths: int = 65536,
    n_outer: int = 512,
    n_inner: int = 64,
):
    """LSM lower bound and Andersen-Broadie dual upper bound for the
    Bermudan swaption on exact-transition paths (no discretization bias).

    Returns ``(lower, se_lower, upper, se_upper)``.  ``generator`` is a
    ``torch.Generator`` on the curve's device or a replay; everything runs
    on the curve's device."""
    schedule, exercise = _schedule_and_exercise(params, schedule, exercise)
    return _bermudan_mc_impl(
        params, to_tensor(strike_rate, schedule.dtype, schedule.device), schedule, generator,
        payer=payer, exercise=exercise, n_paths=n_paths, n_outer=n_outer, n_inner=n_inner)
