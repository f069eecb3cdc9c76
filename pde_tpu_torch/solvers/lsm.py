"""American option pricing by Longstaff-Schwartz least-squares Monte Carlo
(twin of ``pde_tpu/solvers/lsm.py``).

A simulation-based route to the American prices the ADI LCP solver computes
on a grid (:mod:`pde_tpu_torch.solvers.heston_adi`, ``american_method=
"it_lcp"``), and the one route that scales past two state dimensions.

Paths come from the stored-path QE simulation
(:func:`pde_tpu_torch.models.heston_mc.simulate_qe_paths`); the backward
induction is a loop over the time-reversed path array, and each step's
cross-sectional regression is a (k x k) normal-equations solve whose Gram
matrix is an (n_paths x k)^T (n_paths x k) matmul.  In-the-money selection
is a weight vector, not a gather.  The matmuls run in full float32 (TF32
off), and each step's solve is ``torch.linalg.solve_ex``, whose ``info``
is read once, after the march, so the march never waits on the host.  A
date with no path in the money has an all-zero Gram matrix; its solve
fails, and its coefficients are NaN, as the reference's
``jnp.linalg.solve`` leaves them: no path can exercise there (the weights
are zero), and a frozen NaN policy never exercises.  Where paths are in
the money the ridge keeps the Gram matrix nonsingular, and a failed solve
there raises.

Algorithm (Longstaff & Schwartz 2001):

1. simulate S, v on t_1..t_N,
2. at expiry V = payoff(S_N),
3. backward for t = N-1..1: regress the discounted continuation value on a
   polynomial basis in (moneyness, variance) over in-the-money paths, and
   exercise where intrinsic exceeds the fitted continuation,
4. price = E[discounted cashflow], never exercising at t_0 (the t_0
   continuation is the price itself).

The classic in-sample estimator: the same paths choose the policy and value
it (policy suboptimality biases it low, in-sample peeking high).
"""

from __future__ import annotations

import torch

from ..calibrate.lm import _full_fp32_matmul
from ..core.precision import device_of, result_dtype, to_tensor
from ..models.heston import HestonParams
from ..models.heston_mc import _draws, _mc_estimate, _sign, simulate_qe_paths

__all__ = [
    "price_american_lsm",
    "price_american_lsm_batch",
    "lsm_backward_induction",
]

_RIDGE = 1e-7


def _basis(s_norm, v):
    """Regression features: cubic in normalized spot, linear in variance
    plus the cross term, 6 functions.  s_norm = S/K keeps the Gram matrix
    well-conditioned at any strike scale."""
    one = torch.ones_like(s_norm)
    return torch.stack([one, s_norm, s_norm * s_norm, s_norm**3, v, s_norm * v], dim=-1)


def _reduce_sum(x, axis_name):
    """Sum over the paths.  A path axis sharded over devices (``axis_name``)
    waits for the port of ``pde_tpu/parallel`` (ROADMAP item A.7)."""
    if axis_name is not None:
        raise NotImplementedError(
            "lsm: axis_name (a path axis sharded over devices) waits for the "
            "port of pde_tpu/parallel (ROADMAP item A.7)")
    return torch.sum(x, dim=0)


def _solve(gram, rhs, n_itm, failures):
    """``gram^-1 rhs`` by ``solve_ex``; NaN where the solve failed (a date
    with no path in the money: zero weights, an all-zero Gram matrix), and
    each failure on a date with paths in the money kept in ``failures``."""
    beta, info = torch.linalg.solve_ex(gram, rhs)
    failed = info != 0
    failures.append(failed & (n_itm > 0))
    return torch.where(failed.reshape(failed.shape + (1,) * (beta.ndim - info.ndim)),
                       torch.nan, beta)


def _solved(failures):
    """Raise if a regression with paths in the money met a singular Gram
    matrix (one host read for the whole march)."""
    if failures and bool(torch.stack(failures).any()):
        raise RuntimeError("lsm: a regression's Gram matrix was singular")


def lsm_backward_induction(
    s_path, v_path, strike, sign, disc, *, axis_name=None,
    collect_policy: bool = False,
):
    """Longstaff-Schwartz backward induction over stored paths.

    ``s_path``/``v_path`` are ``(n_steps, n_paths)``.  Returns the per-path
    cashflow at t_1 (discounted to t_1; callers discount the last step to
    t_0).  With ``collect_policy=True`` also returns ``(gamma, c)`` of
    shapes ``(n_steps - 1, F)`` / ``(n_steps - 1,)`` in DATE order
    (t_1..t_{N-1}): the fitted continuation in raw feature space,
    ``cont_hat = basis(S/K, v) @ gamma[t] + c[t]``, the frozen exercise
    policy of the dual bound (:mod:`pde_tpu_torch.solvers.lsm_dual`).
    ``axis_name`` raises ``NotImplementedError`` until ``parallel`` is
    ported.
    """
    dtype, device = s_path.dtype, s_path.device
    k_arr = to_tensor(strike, dtype, device)
    sign = to_tensor(sign, dtype, device)
    disc = to_tensor(disc, dtype, device)

    def payoff(s):
        return torch.clamp_min(sign * (s - k_arr), 0.0)

    F = 6
    is_const = torch.arange(F, device=device) == 0
    eye = torch.eye(F, dtype=dtype, device=device)
    cashflow = payoff(s_path[-1])
    gammas, cs, failures = [], [], []
    with _full_fp32_matmul():
        for t in range(s_path.shape[0] - 2, -1, -1):
            s_t, v_t = s_path[t], v_path[t]
            cont = cashflow * disc  # continuation value discounted to t
            intrinsic = payoff(s_t)
            w = (intrinsic > 0).to(dtype)  # regress over ITM paths only
            phi = _basis(s_t / k_arr, v_t)
            sum_w = _reduce_sum(w, axis_name)
            n_itm = torch.clamp_min(sum_w, 1.0)
            # standardize the non-constant features over the ITM
            # cross-section: raw polynomial features span ~1..700, and in
            # float32 their Gram matrix is too ill-conditioned to solve; on
            # the standardized scale a scale-relative ridge is safe
            mu = _reduce_sum(phi * w[:, None], axis_name) / n_itm
            var = _reduce_sum((phi - mu) ** 2 * w[:, None], axis_name) / n_itm
            sd = torch.sqrt(torch.clamp_min(var, _RIDGE))
            mu = torch.where(is_const, 0.0, mu)
            sd = torch.where(is_const, 1.0, sd)
            phi = (phi - mu) / sd
            wphi = phi * w[:, None]
            gram = wphi.T @ phi
            gram = gram / n_itm
            ridge = 1e-4 * torch.trace(gram) / F
            gram = gram + ridge * eye
            rhs = _reduce_sum(wphi * cont[:, None], axis_name) / n_itm
            beta = _solve(gram, rhs, sum_w, failures)
            cont_hat = phi @ beta
            exercise = (intrinsic > cont_hat) & (w > 0)
            # raw-space policy: cont_hat = basis @ gamma + c (the
            # standardization folded into the coefficients)
            gamma = beta / sd
            gammas.append(gamma)
            cs.append(-torch.sum(mu * gamma))
            cashflow = torch.where(exercise, intrinsic, cont)
    _solved(failures)
    if collect_policy:
        return cashflow, (torch.stack(gammas[::-1]), torch.stack(cs[::-1]))
    return cashflow


def price_american_lsm(
    params: HestonParams,
    strike,
    maturity,
    spot,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=False,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_paths_fn=None,
    device=None,
):
    """American vanilla via Longstaff-Schwartz.  Returns ``(price, stderr)``.

    Exercise is allowed at the ``n_steps`` equispaced dates t_1..t_N, a
    Bermudan approximation converging to the American price as ``n_steps``
    grows.  ``generator`` is a ``torch.Generator`` on the path's device (or
    a replay, :mod:`pde_tpu_torch.models.heston_mc`).  ``simulate_paths_fn``
    swaps the path generator (the signature of ``simulate_qe_paths``), e.g.
    the Bates jump-overlay simulator.
    """
    dtype = result_dtype(spot, maturity, strike, params.kappa)
    device = device_of(spot, maturity, strike, *params, default=device)
    s_path, v_path = (simulate_paths_fn or simulate_qe_paths)(
        params, spot, maturity, _draws(generator, device),
        n_steps=n_steps, n_paths=n_paths,
        rate=rate, dividend=dividend, antithetic=antithetic, device=device,
    )
    sign = _sign(is_call, (), dtype, device)
    dt = to_tensor(maturity, dtype, device) / n_steps
    disc = torch.exp(-to_tensor(rate, dtype, device) * dt)

    cashflow = lsm_backward_induction(s_path, v_path, strike, sign, disc)
    discounted = cashflow * disc  # discount t_1 -> t_0
    # antithetic pairs are correlated: fold before the stderr (heston_mc)
    price, stderr = _mc_estimate(discounted, n_paths, antithetic)
    # exercise at t_0 itself: deep ITM, the continuation estimate can sit
    # below intrinsic, and the holder would exercise at once
    intrinsic0 = torch.clamp_min(
        sign * (to_tensor(spot, dtype, device) - to_tensor(strike, dtype, device)), 0.0)
    return torch.maximum(price, intrinsic0), stderr


def price_american_lsm_batch(
    params: HestonParams,
    strikes,
    is_call,
    maturity,
    spot,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    device=None,
):
    """A whole American book off ONE path set, with the book axis in the
    matmuls.

    One strike-independent feature matrix ``phi (n_paths, 6)`` per step
    (the regression prediction is invariant to scaling the spot feature,
    and standardization absorbs each strike's S/K normalization exactly);
    every contract's regression moments are three matmuls with the book as
    the M dimension:

        Sraw = w^T  @ (phi ⊗ phi)   (B, 6, 6)  all Gram matrices at once
        m1   = w^T  @ phi           (B, 6)     all ITM feature means
        Sc   = (w·cont)^T @ phi     (B, 6)     all regression targets

    then the closed-form standardization, one batched 6x6 solve and one
    ``phi @ gamma^T`` matmul for every fitted continuation.  Each contract
    keeps its own exercise regression over its own ITM set; only the paths
    are shared.  ``strikes``/``is_call`` broadcast to the book shape;
    returns ``(prices, stderrs)`` of that shape.
    """
    dtype = result_dtype(spot, maturity, strikes, params.kappa)
    device = device_of(spot, maturity, strikes, *params, default=device)
    source = _draws(generator, device)
    strikes = torch.atleast_1d(to_tensor(strikes, dtype, device))
    sign_in = torch.where(torch.as_tensor(is_call, device=device), 1.0, -1.0).to(dtype)
    strikes_b, sign_b = torch.broadcast_tensors(strikes, sign_in)
    book_shape = strikes_b.shape
    k_vec = strikes_b.reshape(-1)  # (B,)
    sg_vec = sign_b.reshape(-1)  # (B,)

    s_path, v_path = simulate_qe_paths(
        params, spot, maturity, source,
        n_steps=n_steps, n_paths=n_paths,
        rate=rate, dividend=dividend, antithetic=antithetic, device=device,
    )
    dt = to_tensor(maturity, dtype, device) / n_steps
    disc = torch.exp(-to_tensor(rate, dtype, device) * dt)
    s0 = to_tensor(spot, dtype, device)
    F = 6
    is_const = torch.arange(F, device=device) == 0
    eye = torch.eye(F, dtype=dtype, device=device)

    def payoff(s):  # (P,) -> (P, B)
        return torch.clamp_min(sg_vec[None, :] * (s[:, None] - k_vec[None, :]), 0.0)

    cashflow = payoff(s_path[-1])
    failures = []
    with _full_fp32_matmul():
        for t in range(n_steps - 2, -1, -1):  # cashflow (P, B)
            s_t, v_t = s_path[t], v_path[t]
            cont = cashflow * disc
            intrinsic = payoff(s_t)  # (P, B)
            w = (intrinsic > 0).to(dtype)  # (P, B)
            phi = _basis(s_t / s0, v_t)  # (P, F), shared
            n_itm = torch.clamp_min(torch.sum(w, dim=0), 1.0)  # (B,)

            outer = (phi[:, :, None] * phi[:, None, :]).reshape(-1, F * F)
            sraw = (w.T @ outer).reshape(-1, F, F)  # (B, F, F)
            m1 = w.T @ phi  # (B, F)
            sc_vec = (w * cont).T @ phi  # (B, F)
            sc_sum = torch.sum(w * cont, dim=0)  # (B,)
            sum_w = torch.sum(w, dim=0)  # (B,) unclamped

            mu = m1 / n_itm[:, None]
            var = torch.diagonal(sraw, dim1=1, dim2=2) / n_itm[:, None] - mu * mu
            sd = torch.sqrt(torch.clamp_min(var, _RIDGE))
            mu = torch.where(is_const[None, :], 0.0, mu)
            sd = torch.where(is_const[None, :], 1.0, sd)

            # standardized Gram/rhs from the raw sums: the full bilinear
            # expansion of sum w (phi_a - mu_a)(phi_b - mu_b) with EXPLICIT
            # first moments m1 (the constant column's mu is forced to 0
            # above, so the shortcut Sraw - n mu mu^T would be wrong in its
            # row and column); exactly the single contract's regression
            gram = (sraw
                    - mu[:, :, None] * m1[:, None, :]
                    - mu[:, None, :] * m1[:, :, None]
                    + sum_w[:, None, None] * mu[:, :, None] * mu[:, None, :])
            gram = gram / (n_itm[:, None, None] * sd[:, :, None] * sd[:, None, :])
            ridge = 1e-4 * torch.diagonal(gram, dim1=1, dim2=2).sum(-1) / F
            gram = gram + ridge[:, None, None] * eye[None]
            rhs = (sc_vec - mu * sc_sum[:, None]) / (sd * n_itm[:, None])

            beta = _solve(gram, rhs[..., None], sum_w, failures)
            gamma = beta[..., 0] / sd  # (B, F)
            c = -torch.sum(mu * gamma, dim=-1)  # (B,)
            cont_hat = phi @ gamma.T + c[None, :]  # (P, B)

            exercise = (intrinsic > cont_hat) & (w > 0)
            cashflow = torch.where(exercise, intrinsic, cont)
    _solved(failures)
    prices, stderrs = _mc_estimate(cashflow * disc, n_paths, antithetic)
    intrinsic0 = torch.clamp_min(sg_vec * (s0 - k_vec), 0.0)
    prices = torch.maximum(prices, intrinsic0)
    return prices.reshape(book_shape), stderrs.reshape(book_shape)
