"""Bermudan swaptions under G2++: exact-transition LSM and the
Andersen-Broadie dual (twin of ``pde_tpu/solvers/bermudan_g2.py``).

The two-factor companion of :mod:`pde_tpu_torch.solvers.bermudan_hw`.  The
state ``(x, y, int (x+y))`` is jointly Gaussian with closed-form moments
(:func:`~pde_tpu_torch.models.g2.g2_joint_increment_moments`), so paths
step from exercise date to exercise date with no discretization bias, and
the same sandwich holds:

    lower (out-of-sample policy value)  <=  price  <=  upper (dual).

The regression basis is the quadratic in ``(x, y)``; each 6x6 normal
equation is solved by ``solve_ex`` and read once after the march, as in
:mod:`pde_tpu_torch.solvers.lsm`.  Each step factors its 3x3 covariance
with the reference's ``1e-18 I`` jitter, which vanishes in float32: a
covariance that is not positive definite in its dtype gives a NaN factor,
as ``jnp.linalg.cholesky`` does, not an error.  The products run in full
float32 (TF32 off).

**Draws.**  A ``torch.Generator`` on the curve's device or a replay
(:mod:`pde_tpu_torch.models.heston_mc`), split as the reference splits its
key: ``(reg, outer, inner)``, then a chain of ``(next, draw)`` pairs, one
``(3,) + paths`` normal draw a step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..calibrate.lm import _full_fp32_matmul
from ..core.precision import cholesky_nan, to_tensor
from ..models import g2 as g2_mod
from ..models.g2 import G2Params
from ..models.heston_mc import _draws
from ..models.rates import _on
from .bermudan_hw import _schedule_and_exercise
from .lsm import _solve, _solved

__all__ = ["remaining_swap_value_g2", "bermudan_swaption_g2_mc"]


def remaining_swap_value_g2(params: G2Params, strike_rate, schedule, j, x, y, payer=True):
    """Value at schedule date ``T_j`` of entering the remaining swap (the
    convention of :func:`~pde_tpu_torch.solvers.bermudan_hw.remaining_swap_value`),
    a function of both factors.  ``j`` is an int; broadcasts over x/y."""
    schedule, k, x, y = _on(params.curve, schedule, strike_rate, x, y)
    taus = torch.diff(schedule)
    pay = schedule[j + 1:]
    coupons = taus[j:] * k[..., None]
    coupons = torch.cat([coupons[..., :-1], coupons[..., -1:] + 1.0], -1)
    bonds = g2_mod.g2_bond(params, pay, schedule[j], x[..., None], y[..., None])
    val = 1.0 - torch.sum(coupons * bonds, dim=-1)
    return val if payer else -val


def _basis2(x, y):
    """Quadratic bivariate basis: 6 features."""
    return torch.stack([torch.ones_like(x), x, y, x * x, y * y, x * y], dim=-1)


def _step_sampler(params, t_a, t_b, dtype):
    """The closed-form step of ``(x, y, log D)`` between two dates:
    ``f(x, y, logd, source) -> (x', y', logd')``."""
    (ea, eb, Ba, Bb), cov = g2_mod.g2_joint_increment_moments(params, t_b - t_a)
    L = cholesky_nan(cov + 1e-18 * torch.eye(3, dtype=dtype, device=cov.device))
    da = g2_mod.g2_phi_integral(params, t_a, t_b)

    def step(xv, yv, logd, key):
        z = key.normal((3,) + tuple(xv.shape), dtype, xv.device)
        with _full_fp32_matmul():
            eps = torch.tensordot(L, z, dims=1)
        x_new = xv * ea + eps[0]
        y_new = yv * eb + eps[1]
        S = xv * Ba + yv * Bb + eps[2]
        return x_new, y_new, logd - da - S

    return step


def _event_steps(params, schedule, exercise_idx, dtype):
    """The closed-form steps from 0 into each date ``schedule[exercise_idx]``
    (:func:`_step_sampler`), one an exercise row."""
    device = schedule.device
    ts = torch.cat([torch.zeros(1, dtype=dtype, device=device),
                    schedule[torch.as_tensor(exercise_idx, device=device)]])
    return [_step_sampler(params, ts[r], ts[r + 1], dtype) for r in range(len(exercise_idx))]


def _simulate_events(steps, n_paths, generator, dtype, device):
    """Exact path panel along ``steps`` (:func:`_event_steps`): ``(xs, ys,
    log_ds)`` of shape (n_ex, n_paths); one ``(next, draw)`` split of the
    draw source a step, as the reference splits its key."""
    k = _draws(generator, device)
    xs, ys, lds = [], [], []
    xv = yv = ld = torch.zeros(n_paths, dtype=dtype, device=device)
    for step in steps:
        k, k_r = k.split(2)
        xv, yv, ld = step(xv, yv, ld, k_r)
        xs.append(xv)
        ys.append(yv)
        lds.append(ld)
    return torch.stack(xs), torch.stack(ys), torch.stack(lds)


def _bermudan_g2_impl(params, strike_rate, schedule, generator, *, payer, exercise, n_paths,
                      n_outer, n_inner):
    dtype, device = schedule.dtype, schedule.device
    ex_idx = tuple(j for j, b in enumerate(exercise) if b)
    n_ex = len(ex_idx)
    steps = _event_steps(params, schedule, ex_idx, dtype)

    def payoff_at(row, x, y):
        return torch.clamp_min(remaining_swap_value_g2(
            params, strike_rate, schedule, ex_idx[row], x, y, payer), 0.0)

    def simulate(n, k):
        return _simulate_events(steps, n, k, dtype, device)

    k_reg, k_out, k_in = _draws(generator, device).split(3)
    with _full_fp32_matmul():
        # -- phase 1: frozen policy (regression in decision-date units) ---
        xs, ys, lds = simulate(n_paths, k_reg)
        ds = torch.exp(lds)
        pay = torch.stack([payoff_at(j, xs[j], ys[j]) for j in range(n_ex)])
        cash = ds[-1] * pay[-1]
        eye = torch.eye(6, dtype=dtype, device=device)
        betas, failures = [], []
        for j in range(n_ex - 2, -1, -1):
            phi = _basis2(xs[j], ys[j])
            w = (pay[j] > 0.0).to(dtype)
            gram = (phi * w[:, None]).T @ phi + 1e-10 * eye
            rhs = (phi * w[:, None]).T @ (cash / ds[j])
            beta = _solve(gram, rhs, torch.sum(w), failures)
            cont = phi @ beta
            ex = (pay[j] > 0.0) & (pay[j] > cont)
            cash = torch.where(ex, ds[j] * pay[j], cash)
            betas.append(beta)
        _solved(failures)
        betas = torch.stack(betas[::-1] + [torch.zeros(6, dtype=dtype, device=device)])

        def policy_stops(row, x, y):
            if row == n_ex - 1:
                return torch.ones(x.shape, dtype=torch.bool, device=device)
            hv = payoff_at(row, x, y)
            cont = _basis2(x, y) @ betas[row]
            return (hv > 0.0) & (hv > cont)

        def continuation(start, x0, y0, logd0, k_t):
            val = torch.zeros_like(x0)
            active = torch.ones(x0.shape, dtype=torch.bool, device=device)
            xv, yv, ld = x0, y0, logd0
            for row in range(start + 1, n_ex):
                k_t, k_u = k_t.split(2)
                xv, yv, ld = steps[row](xv, yv, ld, k_u)
                stop = active & policy_stops(row, xv, yv)
                val = val + torch.where(stop, torch.exp(ld) * payoff_at(row, xv, yv), 0.0)
                active = active & ~stop
            return val

        # -- phase 2: out-of-sample lower bound --------------------------
        n0 = n_outer * n_inner
        k0, k_in = k_in.split(2)
        zeros = torch.zeros(n0, dtype=dtype, device=device)
        val0 = continuation(-1, zeros, zeros, zeros, k0)
        lower = torch.mean(val0)
        se_lower = torch.std(val0, correction=0) / (1.0 * n0) ** 0.5

        # -- phase 3: dual -----------------------------------------------
        xs_o, ys_o, lds_o = simulate(n_outer, k_out)
        h_o = torch.stack([payoff_at(j, xs_o[j], ys_o[j]) for j in range(n_ex)]) * torch.exp(
            lds_o)
        m = torch.zeros(n_outer, dtype=dtype, device=device)
        g_max = torch.full((n_outer,), -torch.inf, dtype=dtype, device=device)
        c_prev = lower
        for row in range(n_ex):
            if row < n_ex - 1:
                k_row, k_in = k_in.split(2)
                rep = lambda a: torch.repeat_interleave(  # noqa: E731
                    a[row], n_inner, output_size=n0)  # the output size given: no host read
                c_here = torch.mean(continuation(row, rep(xs_o), rep(ys_o), rep(lds_o), k_row)
                                    .reshape(n_outer, n_inner), dim=1)
                stops = policy_stops(row, xs_o[row], ys_o[row])
                v_hat = torch.where(stops, h_o[row], c_here)
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


def bermudan_swaption_g2_mc(
    params: G2Params,
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
    """Bermudan swaption price sandwich under G2++ (exact transitions):
    ``(lower, se_lower, upper, se_upper)``, the conventions of
    :func:`~pde_tpu_torch.solvers.bermudan_hw.bermudan_swaption_mc`.  Runs
    on the curve's device."""
    schedule, exercise = _schedule_and_exercise(params, schedule, exercise)
    return _bermudan_g2_impl(
        params, to_tensor(strike_rate, schedule.dtype, schedule.device), schedule, generator,
        payer=payer, exercise=exercise, n_paths=n_paths, n_outer=n_outer, n_inner=n_inner)
