"""Credit: hazard-rate curves, CDS pricing and bootstrap, and the
closed-form swap CVA (twin of ``pde_tpu/models/credit.py``).

* :class:`HazardCurve`: survival probabilities ``Q(t)`` with log-linear
  interpolation (piecewise-constant hazard rates), the market standard.
* CDS legs under independence of rates and default: premium leg with the
  half-period accrual-on-default convention, protection leg as a sum over
  default buckets with midpoint discounting.
* :func:`bootstrap_hazard`: strictly sequential pillar-by-pillar Newton
  with the reference's fixed trip count, each pillar solved against the
  same legs the curve is priced with, so repricing recovers the input
  spreads to Newton tolerance.  The legs are linear in the survival reads,
  and a read is linear in the log-survival at the pillars, so the Newton
  derivative is the same legs applied to Q(t) d log Q(t) / dh: closed form,
  no nested autograd, and the hazards stay differentiable in the spreads
  through every trip.  Pillar and schedule grids are read once on the host.
* CVA of a single swap: the discounted expected positive exposure at a
  reset date IS a European swaption expiring there, so
  :func:`cva_swap_hw` is a closed-form Jamshidian strip.

The netting-set Monte Carlo CVA (``cva_netting_hw_mc``) needs the
Hull-White Bermudan module's event simulation and comes with it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.precision import result_dtype, to_tensor
from . import rates
from .rates import (DiscountCurve, HullWhiteParams, _host_floats, _linspace, _on, _plan_reads,
                    _read_logs)

__all__ = [
    "HazardCurve",
    "flat_hazard",
    "cds_legs",
    "cds_par_spread",
    "cds_par_spreads",
    "cds_value",
    "bootstrap_hazard",
    "cva_swap_hw",
    "SwapTrade",
]


class HazardCurve(NamedTuple):
    """Survival curve: ``survival[i] = Q(tau > times[i])``; log-linear
    interpolation (piecewise-constant hazard), flat-hazard extrapolation.
    Same structure as ``rates.DiscountCurve``: a survival probability IS a
    discount factor at the hazard rate."""

    times: torch.Tensor
    survival: torch.Tensor

    def q(self, t):
        """Q(t): broadcasts over t."""
        return DiscountCurve(self.times, self.survival).df(t)

    def hazard(self, t, eps: float = 1e-5):
        """Instantaneous hazard rate lambda(t)."""
        return DiscountCurve(self.times, self.survival).inst_forward(t, eps)


def flat_hazard(lam, horizon: float = 50.0, dtype=None, device=None):
    """Constant hazard ``lam`` on its device (the card for a plain number,
    unless ``device`` names another)."""
    curve = rates.flat_curve(lam, horizon, 2, dtype, device)
    return HazardCurve(curve.times, curve.dfs)


class _Schedule(NamedTuple):
    """A CDS's reads, fixed by its maturity: the curve's discount factors
    at the pay dates and bucket midpoints, the accrual, and where the
    hazard curve is read (pay dates, their period starts, bucket edges)."""

    tau: float
    d_pay: torch.Tensor
    d_mid: torch.Tensor
    n_pay: int
    t_reads: torch.Tensor


def _default_buckets(maturity, n_buckets, dtype, device):
    """The ``n_buckets + 1`` edges of the protection leg's default buckets
    on [0, maturity]."""
    return _linspace(0.0, maturity, n_buckets + 1, dtype, device)


def _schedule(curve: DiscountCurve, maturity, freq, n_buckets, dtype, device) -> _Schedule:
    """The schedule of a CDS from 0 to ``maturity``: ``n_pay =
    round(maturity / freq)`` equal periods ending exactly at ``maturity``
    (so accruals tile [0, maturity] whatever ``freq``), and
    ``n_buckets`` default buckets."""
    m = _host_floats(maturity)[0]
    n_pay = max(int(round(m / freq)), 1)
    tau = m / n_pay
    pay = _linspace(tau, m, n_pay, dtype, device)
    tb = _default_buckets(m, n_buckets, dtype, device)
    mid = 0.5 * (tb[:-1] + tb[1:])
    return _Schedule(tau, curve.df(pay), curve.df(mid), n_pay, torch.cat([pay, pay - tau, tb]))


def _legs(s: _Schedule, q, recovery):
    """(premium per unit spread, protection) from the survival reads ``q``
    at ``s.t_reads``; linear in ``q``."""
    q_pay, q_prev, q_b = q[:s.n_pay], q[s.n_pay:2 * s.n_pay], q[2 * s.n_pay:]
    premium = torch.sum(s.tau * s.d_pay * (q_pay + 0.5 * (q_prev - q_pay)))
    protect = (1.0 - recovery) * torch.sum(s.d_mid * (q_b[:-1] - q_b[1:]))
    return premium, protect


def cds_legs(curve: DiscountCurve, hazard: HazardCurve, maturity, *, recovery=0.4,
             freq: float = 0.25, n_buckets: int = 200):
    """(premium_leg_per_unit_spread, protection_leg) for a CDS from 0 to
    ``maturity``.

    premium = sum_i tau_i D(t_i) [Q(t_i) + (Q(t_{i-1}) - Q(t_i))/2]
    protect = (1-R) sum_k D(mid_k) (Q(t_{k-1}) - Q(t_k))

    ``maturity`` is read on the host (it fixes the schedule): ``n_pay =
    round(maturity/freq)`` equally spaced payments ending exactly at
    ``maturity``, accrual ``maturity/n_pay``, so the accrual windows tile
    [0, maturity] exactly.
    """
    s = _schedule(curve, maturity, freq, n_buckets, result_dtype(curve.dfs, hazard.survival),
                  curve.dfs.device)
    return _legs(s, hazard.q(s.t_reads), recovery)


def cds_par_spread(curve, hazard, maturity, *, recovery=0.4, freq: float = 0.25,
                   n_buckets: int = 200):
    """Running spread s* with zero upfront: protection / premium annuity."""
    prem, prot = cds_legs(curve, hazard, maturity, recovery=recovery, freq=freq,
                          n_buckets=n_buckets)
    return prot / prem


def cds_par_spreads(curve, hazard, maturities, *, recovery=0.4, freq: float = 0.25,
                    n_buckets: int = 200):
    """Par spreads for a strip of maturities, a (n,) tensor (maturities
    read on the host)."""
    return torch.stack([cds_par_spread(curve, hazard, m, recovery=recovery, freq=freq,
                                       n_buckets=n_buckets)
                        for m in _host_floats(maturities)])


def cds_value(curve, hazard, maturity, spread, *, recovery=0.4, notional=1.0,
              freq: float = 0.25, n_buckets: int = 200):
    """Value to the PROTECTION BUYER of a running-spread CDS."""
    prem, prot = cds_legs(curve, hazard, maturity, recovery=recovery, freq=freq,
                          n_buckets=n_buckets)
    return notional * (prot - spread * prem)


def bootstrap_hazard(curve: DiscountCurve, pillars, spreads, *, recovery=0.4,
                     freq: float = 0.25, n_buckets: int = 200, n_newton: int = 12):
    """Piecewise-constant hazard curve from par CDS spreads.

    Strictly sequential pillar-by-pillar fixed-trip Newton (clipped to
    [1e-8, 10]), each pillar solved against the same legs the curve is
    priced with (:func:`cds_legs`), so repricing the pillars through
    :func:`cds_par_spread` recovers the inputs to Newton tolerance.  Pillar
    times are read on the host (they fix the schedules); spreads, curve
    entries and recovery may carry gradients.  Runs on the curve's device.
    Returns ``(HazardCurve, hazards)``.
    """
    pillars_f = _host_floats(pillars)
    dtype = result_dtype(curve.dfs, spreads)
    dev = curve.dfs.device
    spreads = to_tensor(spreads, dtype, dev)
    recovery_t = to_tensor(recovery, dtype, dev)
    p_arr = to_tensor(pillars_f, dtype, dev)
    n_p = len(pillars_f)
    dts = torch.diff(p_arr, prepend=p_arr.new_zeros(1))
    idx = torch.arange(n_p, device=dev)

    hs = []
    for i, t1 in enumerate(pillars_f):
        s = _schedule(curve, t1, freq, n_buckets, dtype, dev)
        reads = _plan_reads(p_arr, s.t_reads)
        # log Q at the pillars with segment i (and the later ones, beyond
        # t1 and never read) at hazard h, and its derivative in h
        dlog = -torch.cumsum(torch.where(idx >= i, dts, 0.0), 0)
        known = torch.stack(hs) if hs else p_arr.new_zeros(0)

        def obj_and_slope(h, s=s, reads=reads, dlog=dlog, known=known, spread=spreads[i]):
            hz = torch.cat([known, h.expand(n_p - len(known))])
            q = torch.exp(_read_logs(reads, -torch.cumsum(hz * dts, 0)))
            dq = q * _read_logs(reads, dlog)
            prem, prot = _legs(s, q, recovery_t)
            dprem, dprot = _legs(s, dq, recovery_t)
            return spread * prem - prot, spread * dprem - dprot

        # the credit-triangle seed s / (1 - R)
        h = spreads[i] / torch.clamp_min(1.0 - recovery_t, 1e-6)
        for _ in range(n_newton):
            obj, slope = obj_and_slope(h)
            h = torch.clamp(h - obj / slope, 1e-8, 10.0)
        hs.append(h)

    hazards = torch.stack(hs)
    return HazardCurve(p_arr, torch.exp(-torch.cumsum(hazards * dts, 0))), hazards


# ---------------------------------------------------------------------------
# CVA


def cva_swap_hw(params: HullWhiteParams, hazard: HazardCurve, strike_rate, schedule, *,
                recovery=0.4, payer: bool = True, notional=1.0):
    """Closed-form CVA of a single IR swap against a defaultable
    counterparty (independence assumption).

    The discounted expected positive exposure at reset date T_j equals the
    European swaption expiring at T_j into the remaining swap, so

        CVA = (1-R) sum_j  Swaption(T_j) [Q(T_j) - Q(T_{j+1})]

    a Jamshidian strip, no simulation.  Default in (T_j, T_{j+1}] is paired
    with the exposure at the bucket start T_j; default before T_0
    contributes nothing.  The swaptions' pay dates are ragged (each expiry
    pays the rest of the schedule), so they are priced one at a time.
    """
    schedule, = _on(params.curve, schedule)
    m = schedule.shape[0] - 1
    q = hazard.q(schedule)
    swps = torch.stack([rates.hw_swaption(params, strike_rate, schedule[j], schedule[j + 1:],
                                          payer=payer) for j in range(m)])
    dq = q[:-1] - q[1:]
    return notional * (1.0 - recovery) * torch.sum(swps * dq[:m])


class SwapTrade(NamedTuple):
    """One swap in a netting set (all trades of a set share one reset
    schedule).  ``payer_sign`` = +1 pays fixed (gains when rates rise), -1
    receives fixed."""

    strike_rate: torch.Tensor
    payer_sign: torch.Tensor      # +1 payer / -1 receiver
    notional: torch.Tensor
