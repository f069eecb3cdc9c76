"""Andersen-Broadie dual (upper-bound) estimator for LSM American pricing
(twin of ``pde_tpu/solvers/lsm_dual.py``).

The LSM lower bound (:mod:`pde_tpu_torch.solvers.lsm`) values a
suboptimal policy, so it sits below the true American price; this module
computes the matching martingale-duality UPPER bound (Andersen & Broadie
2004; Rogers 2002), so that a price carries the sandwich

    lower - 4 se_l  <=  true price  <=  upper + 4 se_u.

Method.  Freeze the LSM exercise policy (the raw-space coefficients of
``lsm_backward_induction(collect_policy=True)``).  The duality martingale
needs, at every outer state ``X_t``, the policy continuation value
``C_t(X_t) = E[h_tau | X_t]`` (tau the first policy exercise after t),
estimated by ``n_inner`` nested sub-simulations that follow the frozen
policy to its stopping time.  With ``V_t = h_t`` where the policy stops and
``C_t`` elsewhere, ``M_t = sum_{u<=t} (V_u(X_u) - C_{u-1}(X_{u-1}))`` is a
martingale in the enlarged filtration even with inner-sample noise, so
``price <= E[max_t (h_t - M_t)]``; inner noise only pushes the bound up.
All values are in time-0 discounted units.

The outer x inner bundle is one flat path axis (``n_outer * n_inner``
paths per start date), and the loop over start dates runs on the host with
fixed trip counts.  Cost is O(n_steps^2 / 2) QE steps per inner path: keep
``n_steps`` at Bermudan grade (8-32).  The draw source is split as the
reference splits its key: ``(reg, outer, inner)``, then one bundle key for
C_0 and one per date, each split per step.
"""

from __future__ import annotations

import math

import torch

from ..calibrate.lm import _full_fp32_matmul
from ..core.precision import device_of, result_dtype, to_tensor
from ..models.heston import HestonParams
from ..models.heston_mc import _draws, _make_qe_step, _qe_constants, _sign, simulate_qe_paths
from .lsm import _basis, lsm_backward_induction

__all__ = ["dual_upper_bound"]


def dual_upper_bound(
    params: HestonParams,
    strike,
    maturity,
    spot,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=False,
    n_steps: int = 16,
    n_reg_paths: int = 32768,
    n_outer: int = 1024,
    n_inner: int = 64,
    device=None,
):
    """American option price sandwich under the frozen LSM policy.

    Returns ``(lower, se_lower, upper, se_upper)``: ``lower`` is an
    out-of-sample policy valuation (fresh paths, so a genuine lower bound in
    expectation), ``upper`` the Andersen-Broadie dual bound; ``upper -
    lower`` is the duality gap.  ``generator`` is a ``torch.Generator`` on
    the path's device (or a replay, :mod:`pde_tpu_torch.models.heston_mc`).
    """
    dtype = result_dtype(spot, maturity, strike, params.kappa)
    device = device_of(spot, maturity, strike, *params, default=device)
    k_reg, k_outer, k_inner = _draws(generator, device).split(3)
    t = lambda x: to_tensor(x, dtype, device)  # noqa: E731
    k_arr, s0 = t(strike), t(spot)
    sign = _sign(is_call, (), dtype, device)
    N = n_steps
    dt = t(maturity) / N
    disc = torch.exp(-t(rate) * dt)
    disc0 = disc ** torch.arange(1, N + 1, dtype=dtype, device=device)  # e^{-r t_j}

    def payoff(s):
        return torch.clamp_min(sign * (s - k_arr), 0.0)

    with _full_fp32_matmul():
        # -- phase 1: fit the policy on its own path set -------------------
        s_reg, v_reg = simulate_qe_paths(
            params, spot, maturity, k_reg,
            n_steps=N, n_paths=n_reg_paths, rate=rate, dividend=dividend, device=device)
        _, (gammas, cs) = lsm_backward_induction(
            s_reg, v_reg, strike, sign, disc, collect_policy=True)

        def policy_stops(s, v, u):
            """Exercise at date row u (0-based, dates t_1..t_N)?  The
            terminal row always exercises (its payoff may be 0)."""
            if u == N - 1:
                return torch.ones(s.shape, dtype=torch.bool, device=device)
            intr = payoff(s)
            cont_hat = _basis(s / k_arr, v) @ gammas[u] + cs[u]
            return (intr > 0.0) & (intr > cont_hat)

        # -- inner continuation bundles ------------------------------------
        E, c1, c2, k0_plain, k1, k2, k3, k4 = _qe_constants(params, dt, dtype)
        drift = (t(rate) - t(dividend)) * dt

        def continuation(ln_s, v, start_row, k_t, n_flat):
            """Mean discounted-to-0 policy payoff of CONTINUING from state
            (ln_s, v) at date row ``start_row`` (-1 = time 0): simulates
            rows start_row+1 .. N-1 under the frozen policy."""
            qe = _make_qe_step(E, c1, c2, t(params.theta), k0_plain, k1, k2, k3, k4, drift,
                               n_flat, False, True, dtype)
            rows = range(start_row + 1, N)
            active = torch.ones(ln_s.shape, dtype=torch.bool, device=device)
            val = torch.zeros(ln_s.shape, dtype=dtype, device=device)
            for u, k_u in zip(rows, k_t.split(len(rows))):
                ln_s, v = qe(ln_s, v, k_u)
                s_n = torch.exp(ln_s)
                ex = active & policy_stops(s_n, v, u)
                val = val + torch.where(ex, disc0[u] * payoff(s_n), 0.0)
                active = active & ~ex
            return val

        # -- phase 2: outer paths + h --------------------------------------
        s_out, v_out = simulate_qe_paths(
            params, spot, maturity, k_outer,
            n_steps=N, n_paths=n_outer, rate=rate, dividend=dividend,
            antithetic=False, device=device)
        h = disc0[:, None] * payoff(s_out)  # (N, n_outer)

        # C_0 and the out-of-sample lower bound share one bundle from X_0
        n0 = n_outer * n_inner
        k0_key, k_inner = k_inner.split(2)
        val0 = continuation(torch.log(s0).expand(n0), t(params.v0).expand(n0), -1, k0_key, n0)
        c_prev = torch.mean(val0)  # scalar C_0
        lower = torch.maximum(c_prev, payoff(s0))
        se_lower = torch.std(val0, correction=0) / math.sqrt(1.0 * n0)

        # -- phase 3: martingale increments date by date -------------------
        m = torch.zeros((n_outer,), dtype=dtype, device=device)
        g_max = torch.full((n_outer,), -math.inf, dtype=dtype, device=device)
        for row in range(N):  # dates t_1..t_N
            s_t, v_t = s_out[row], v_out[row]
            if row < N - 1:
                k_row, k_inner = k_inner.split(2)
                ln_rep = torch.repeat_interleave(torch.log(s_t), n_inner)
                v_rep = torch.repeat_interleave(v_t, n_inner)
                c_here = torch.mean(
                    continuation(ln_rep, v_rep, row, k_row, n0).reshape(n_outer, n_inner),
                    dim=1)  # C_row(X_row)
                v_hat = torch.where(policy_stops(s_t, v_t, row), h[row], c_here)
            else:
                v_hat = h[row]  # terminal: exact
                c_here = torch.zeros_like(v_hat)
            m = m + (v_hat - c_prev)
            g_max = torch.maximum(g_max, h[row] - m)
            c_prev = c_here
        g_max = torch.maximum(g_max, payoff(s0))  # exercise at t_0
        upper = torch.mean(g_max)
        se_upper = torch.std(g_max, correction=0) / math.sqrt(1.0 * n_outer)
    return lower, se_lower, upper, se_upper
