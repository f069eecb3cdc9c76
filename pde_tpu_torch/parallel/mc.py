"""Mesh-sharded Monte Carlo: the path axis distributed over ranks (twin of
``pde_tpu/parallel/mc.py``).

Every pricer keeps the reference's global-in, global-out contract: each
rank of the mesh dimension ``axis`` (default the mesh's first) simulates
``n_paths / P`` paths of its own and takes part in the reductions, and
every rank returns the same global estimate.

* :func:`price_european_mc_sharded` — pure data parallelism: the
  price/stderr moments are three ``all_reduce``d scalars
  (:func:`_global_mean_stderr`, one collective).
* :func:`price_american_lsm_sharded` — the Longstaff-Schwartz induction
  with the regression's Gram and moment sums ``all_reduce``d at each
  exercise date (``solvers/lsm.lsm_backward_induction`` with
  ``axis_name``), so every rank fits the GLOBAL continuation regression
  and applies the same exercise policy to its local paths.
* :func:`calibrate_leverage_sharded` — the SLV particle calibration with
  E[v | S] from global bin sums each step (``models/slv`` with
  ``axis_name``).
* :func:`bermudan_swaption_lsm_sharded`, :func:`cva_netting_sharded` — the
  rates desk's Bermudan LSM and netted CVA on exact-transition panels.

Draws.  ``key`` is an int seed, and then rank i draws from a
``torch.Generator`` on its device seeded from ``(key, i)`` (the
counterpart of ``fold_in(key, axis_index)``); or a sequence of P draw
sources, one a rank, each a ``torch.Generator`` on that rank's device or a
replay (``models/heston_mc._Replay``), so that the ranks can be fed any
stream, e.g. the reference's own per-device draws in tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..calibrate.lm import _full_fp32_matmul
from ..core.precision import result_dtype, to_tensor
from ..models.heston import HestonParams
from ..models.heston_mc import _sign, simulate_qe, simulate_qe_paths
from ..solvers.lsm import lsm_backward_induction
from .mesh import axis_index, axis_size, mesh_device, psum, using_mesh

__all__ = ["price_european_mc_sharded", "price_american_lsm_sharded",
           "calibrate_leverage_sharded", "cva_netting_sharded",
           "bermudan_swaption_lsm_sharded"]


def _local_count(mesh, axis, n_paths, antithetic=False, what="MC"):
    """This rank's path count; raises as the reference does."""
    ndev = axis_size(mesh, axis)
    if n_paths % ndev:
        raise ValueError(f"n_paths {n_paths} not divisible by axis size {ndev}")
    n_local = n_paths // ndev
    if antithetic and n_local % 2:
        raise ValueError(f"antithetic sharded {what} needs an even per-device count")
    return n_local


def _rank_source(key, mesh, axis, device):
    """This rank's draw source: the counterpart of ``fold_in(key,
    axis_index)``.  An int seeds a generator on ``device`` from (key,
    index); a sequence gives each rank its own entry."""
    idx = axis_index(mesh, axis)
    if isinstance(key, (list, tuple)):
        if len(key) != axis_size(mesh, axis):
            raise ValueError(f"{len(key)} draw sources for {axis_size(mesh, axis)} ranks")
        return key[idx]
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        seed = int(np.random.SeedSequence([int(key), idx]).generate_state(1, np.uint64)[0])
        return torch.Generator(device=device).manual_seed(seed >> 1)
    raise TypeError("key must be an int seed or a sequence of one draw source a rank, "
                    f"not {type(key).__name__}")


def _pair_fold(discounted, n_local, antithetic):
    """Antithetic pairs are laid out [first half | mirrored half] on EACH
    rank — fold locally before the global moment reduction."""
    if antithetic:
        h = n_local // 2
        return 0.5 * (discounted[:h] + discounted[h:])
    return discounted


def _global_mean_stderr(y, axis_name):
    """Mean and standard error over the global (all-rank) sample from local
    values ``y`` (path axis 0; trailing axes are separate estimates): the
    three sums (n, sum, sum of squares) in one ``all_reduce``."""
    n_local = torch.full(y.shape[1:], float(y.shape[0]), dtype=y.dtype, device=y.device)
    n, s1, s2 = psum(torch.stack([n_local, torch.sum(y, 0), torch.sum(y * y, 0)]), axis_name)
    mean = s1 / n
    var = (s2 - n * mean * mean) / (n - 1.0)
    return mean, torch.sqrt(torch.clamp_min(var, 0.0) / n)


def price_european_mc_sharded(
    params: HestonParams,
    strike,
    maturity,
    spot,
    key,
    mesh,
    *,
    axis: str | None = None,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
):
    """European vanilla via QE MC with ``n_paths`` split over ``axis``.

    ``n_paths`` is the GLOBAL path count; it must divide by the axis size
    (and by 2 per rank when antithetic).  Returns ``(price, stderr)``
    scalars on every rank.  The estimate differs from the single-device
    pricer's only statistically, not systematically.
    """
    axis = axis or mesh.mesh_dim_names[0]
    n_local = _local_count(mesh, axis, n_paths, antithetic)
    dev = mesh_device(mesh)
    source = _rank_source(key, mesh, axis, dev)
    paths = simulate_qe(params, spot, maturity, source, n_steps=n_steps, n_paths=n_local,
                        rate=rate, dividend=dividend, antithetic=antithetic, device=dev)
    dtype = paths.spot.dtype
    disc = torch.exp(-to_tensor(rate, dtype, dev) * to_tensor(maturity, dtype, dev))
    payoff = torch.clamp_min(_sign(is_call, (), dtype, dev)
                             * (paths.spot - to_tensor(strike, dtype, dev)), 0.0)
    with using_mesh(mesh):
        return _global_mean_stderr(_pair_fold(disc * payoff, n_local, antithetic), axis)


def price_american_lsm_sharded(
    params: HestonParams,
    strike,
    maturity,
    spot,
    key,
    mesh,
    *,
    axis: str | None = None,
    rate=0.0,
    dividend=0.0,
    is_call=False,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
):
    """American vanilla via Longstaff-Schwartz with the path axis sharded.

    Semantics match ``solvers/lsm.price_american_lsm`` run on the same
    global cross-section: the continuation regression at each exercise
    date is fitted over ALL paths (``all_reduce``d normal equations), so
    the policy does not degrade as ranks are added.
    """
    axis = axis or mesh.mesh_dim_names[0]
    n_local = _local_count(mesh, axis, n_paths, antithetic, "LSM")
    dev = mesh_device(mesh)
    source = _rank_source(key, mesh, axis, dev)
    s_path, v_path = simulate_qe_paths(params, spot, maturity, source, n_steps=n_steps,
                                       n_paths=n_local, rate=rate, dividend=dividend,
                                       antithetic=antithetic, device=dev)
    dtype = s_path.dtype
    sign = _sign(is_call, (), dtype, dev)
    dt = to_tensor(maturity, dtype, dev) / n_steps
    disc = torch.exp(-to_tensor(rate, dtype, dev) * dt)
    with using_mesh(mesh):
        cashflow = lsm_backward_induction(s_path, v_path, strike, sign, disc, axis_name=axis)
        price, stderr = _global_mean_stderr(_pair_fold(cashflow * disc, n_local, antithetic),
                                            axis)
    intrinsic = torch.clamp_min(
        sign * (to_tensor(spot, dtype, dev) - to_tensor(strike, dtype, dev)), 0.0)
    return torch.maximum(price, intrinsic), stderr


def calibrate_leverage_sharded(
    params: HestonParams,
    vol_fn,
    spot,
    maturity,
    key,
    mesh,
    *,
    axis: str | None = None,
    strikes=None,
    rate=0.0,
    dividend=0.0,
    n_steps: int = 48,
    n_paths: int = 65536,
    n_bins: int = 31,
    antithetic: bool = True,
):
    """Distributed SLV particle calibration: the particle cloud sharded
    over ``axis``, the per-step conditional expectation E[v | S] built from
    GLOBAL bin sums by one ``all_reduce`` a step (``models/slv`` with
    ``axis_name``), so every rank computes the SAME leverage rows.

    Returns ``(LeverageSurface, prices, stderrs)`` — the surface the same
    on every rank, and validation call prices over the global terminal
    cloud for the given ``strikes`` (ATM-only when omitted).
    """
    from ..models.slv import calibrate_leverage

    axis = axis or mesh.mesh_dim_names[0]
    n_local = _local_count(mesh, axis, n_paths, antithetic, "SLV")
    dev = mesh_device(mesh)
    source = _rank_source(key, mesh, axis, dev)
    with using_mesh(mesh):
        lev, paths = calibrate_leverage(
            params, vol_fn, spot, maturity, source, n_steps=n_steps, n_paths=n_local,
            n_bins=n_bins, rate=rate, dividend=dividend, antithetic=antithetic,
            axis_name=axis, device=dev)
        dtype = paths.spot.dtype
        strikes_a = torch.atleast_1d(to_tensor(spot if strikes is None else strikes, dtype, dev))
        disc = torch.exp(-to_tensor(rate, dtype, dev) * to_tensor(maturity, dtype, dev))
        payoff = torch.clamp_min(paths.spot[:, None] - strikes_a[None, :], 0.0)
        price, stderr = _global_mean_stderr(_pair_fold(disc * payoff, n_local, antithetic), axis)
    return lev, price, stderr


def bermudan_swaption_lsm_sharded(
    params,
    strike_rate,
    schedule,
    key,
    mesh,
    *,
    axis: str | None = None,
    payer: bool = True,
    exercise=None,
    n_paths: int = 65536,
):
    """Bermudan swaption LSM with the path axis sharded over the mesh — the
    multi-rank face of ``solvers/bermudan_hw.bermudan_swaption_mc`` and
    ``solvers/bermudan_g2.bermudan_swaption_g2_mc``.

    Dispatches on the parameter type: one-factor Hull-White
    (``HullWhiteParams``, cubic basis in x) or two-factor G2++
    (``G2Params``, quadratic bivariate basis in (x, y)), both on
    exact-transition exercise-date panels.  The continuation regression at
    each exercise date fits the GLOBAL cross-section via one
    ``all_reduce`` each of the Gram matrix and the moments.  Returns
    ``(price, stderr)``, the in-sample LSM policy value over the global
    path set; with a single exercise date it is the plain European MC.
    """
    from ..models.g2 import G2Params
    from ..models.rates import HullWhiteParams
    from ..solvers import bermudan_g2 as bg2
    from ..solvers import bermudan_hw as bhw

    if not isinstance(params, (HullWhiteParams, G2Params)):
        raise TypeError(
            f"params must be HullWhiteParams or G2Params, got {type(params)}")
    axis = axis or mesh.mesh_dim_names[0]
    n_local = _local_count(mesh, axis, n_paths)
    dev = mesh_device(mesh)
    source = _rank_source(key, mesh, axis, dev)

    dtype = result_dtype(params.curve.dfs, schedule, params.sigma)
    schedule = to_tensor(schedule, dtype, dev)
    strike_rate = to_tensor(strike_rate, dtype, dev)
    m = int(schedule.shape[0]) - 1
    if exercise is None:
        exercise = (True,) * m
    exercise = tuple(bool(b) for b in exercise)
    if len(exercise) != m or not any(exercise):
        raise ValueError("exercise must flag at least one of the M dates")
    ex_idx = tuple(j for j, b in enumerate(exercise) if b)
    n_ex = len(ex_idx)

    if isinstance(params, HullWhiteParams):
        basis = bhw._mc_basis

        def payoff_at(row, state):
            return torch.clamp_min(bhw.remaining_swap_value(
                params, strike_rate, schedule, ex_idx[row], state[0], payer), 0.0)

        xs, log_ds = bhw._simulate_events(params, schedule, ex_idx, n_local, source, dtype)
        states, ds = (xs,), torch.exp(log_ds)
    else:
        basis = bg2._basis2

        def payoff_at(row, state):
            return torch.clamp_min(bg2.remaining_swap_value_g2(
                params, strike_rate, schedule, ex_idx[row], state[0], state[1], payer), 0.0)

        xs, ys, lds = bg2._simulate_events(bg2._event_steps(params, schedule, ex_idx, dtype),
                                           n_local, source, dtype, dev)
        states, ds = (xs, ys), torch.exp(lds)

    def state_at(j):
        return tuple(s[j] for s in states)

    pay = torch.stack([payoff_at(j, state_at(j)) for j in range(n_ex)])
    cash = ds[-1] * pay[-1]
    with using_mesh(mesh), _full_fp32_matmul():
        for j in range(n_ex - 2, -1, -1):
            phi = basis(*state_at(j))
            wphi = phi * (pay[j] > 0.0).to(dtype)[:, None]
            # GLOBAL normal equations at each exercise date
            gram = psum(wphi.T @ phi, axis)
            rhs = psum(wphi.T @ (cash / ds[j]), axis)
            gram = gram + 1e-10 * torch.eye(phi.shape[-1], dtype=dtype, device=dev)
            beta = torch.linalg.solve(gram, rhs)
            cont = phi @ beta
            ex = (pay[j] > 0.0) & (pay[j] > cont)
            cash = torch.where(ex, ds[j] * pay[j], cash)
        return _global_mean_stderr(cash, axis)


def cva_netting_sharded(
    params,
    hazard,
    trades,
    schedule,
    key,
    mesh,
    *,
    recovery=0.4,
    n_paths: int = 65536,
    axis: str | None = None,
):
    """Netting-set CVA with the exposure-path axis sharded over the mesh —
    the multi-rank face of ``models/credit.cva_netting_hw_mc``: each rank
    simulates its own shard of exact Hull-White transitions, and the
    per-date discounted positive exposure is ``all_reduce``d, so every
    rank holds the GLOBAL expected-exposure profile (one collective of
    ``n_dates`` numbers).  Returns ``(cva, ee)``, the same on every rank.
    """
    from ..solvers.bermudan_hw import _simulate_events, remaining_swap_value

    axis = axis or mesh.mesh_dim_names[0]
    n_local = _local_count(mesh, axis, n_paths)
    dev = mesh_device(mesh)
    source = _rank_source(key, mesh, axis, dev)

    dtype = result_dtype(params.curve.dfs, schedule, params.sigma)
    schedule = to_tensor(schedule, dtype, dev)
    n_dates = int(schedule.shape[0]) - 1
    field = lambda f: torch.stack([to_tensor(getattr(t, f), dtype, dev)  # noqa: E731
                                   for t in trades])
    strikes, signs, notionals = field("strike_rate"), field("payer_sign"), field("notional")
    xs, log_ds = _simulate_events(params, schedule, tuple(range(n_dates)), n_local, source,
                                  dtype)
    ds = torch.exp(log_ds)

    def net_value(j):
        vals = torch.stack([
            signs[t] * notionals[t] * remaining_swap_value(
                params, strikes[t], schedule, j, xs[j], payer=True)
            for t in range(strikes.shape[0])
        ])
        return torch.sum(vals, dim=0)

    expo = torch.stack([torch.sum(ds[j] * torch.clamp_min(net_value(j), 0.0))
                        for j in range(n_dates)])
    with using_mesh(mesh):
        tot = psum(torch.cat([expo, torch.full((1,), float(n_local), dtype=dtype,
                                               device=dev)]), axis)
    ee = tot[:-1] / tot[-1]
    curve = type(hazard)(hazard.times.to(device=dev, dtype=dtype),
                         hazard.survival.to(device=dev, dtype=dtype))
    q = curve.q(schedule)
    dq = q[:-1] - q[1:]
    cva = (1.0 - to_tensor(recovery, dtype, dev)) * torch.sum(ee * dq[:n_dates])
    return cva, ee
