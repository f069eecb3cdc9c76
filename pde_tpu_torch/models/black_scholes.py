"""Black-Scholes closed forms and vectorized implied volatility (twin of
``pde_tpu/models/black_scholes.py``, the part the Heston slice uses).

Every function broadcasts over its arguments; the IV solver is a
fixed-iteration masked Newton loop, so it needs no host read per step.
Reference semantics: src/cpp/models/heston.cpp:275-349 and
data/options.py:118-455.
"""

from __future__ import annotations

import math

import torch

from ..core.precision import device_of, result_dtype, to_tensor, where_flag
from ..utils.stats import norm_cdf, norm_pdf

__all__ = ["price", "vega", "implied_vol"]


def _broadcast(*args):
    """Tensors of one floating dtype and device, broadcast together."""
    dtype = result_dtype(*args)
    device = device_of(*args)
    return torch.broadcast_tensors(*(to_tensor(a, dtype, device) for a in args))


def _d1_d2(spot, strike, rate, dividend, maturity, vol):
    forward = spot * torch.exp((rate - dividend) * maturity)
    sqrt_t = torch.sqrt(maturity)
    vs = vol * sqrt_t
    d1 = (torch.log(forward / strike) + 0.5 * vol * vol * maturity) / vs
    d2 = d1 - vs
    return d1, d2


def price(spot, strike, rate, dividend, maturity, vol, is_call=True):
    """European Black-Scholes price (broadcasts over all arguments).

    Matches HestonModel::black_scholes_price (src/cpp/models/heston.cpp:275-294)
    including the intrinsic-value shortcut at zero maturity.
    """
    spot, strike, maturity, vol = _broadcast(spot, strike, maturity, vol)
    safe_T = torch.where(maturity > 0.0, maturity, torch.ones_like(maturity))
    safe_vol = torch.where(vol > 0.0, vol, torch.full_like(vol, 1e-12))
    d1, d2 = _d1_d2(spot, strike, rate, dividend, safe_T, safe_vol)
    disc_r = torch.exp(-rate * safe_T)
    disc_q = torch.exp(-dividend * safe_T)

    call = spot * disc_q * norm_cdf(d1) - strike * disc_r * norm_cdf(d2)
    put = strike * disc_r * norm_cdf(-d2) - spot * disc_q * norm_cdf(-d1)
    val = where_flag(is_call, call, put)

    intrinsic = where_flag(is_call, torch.clamp_min(spot - strike, 0.0),
                           torch.clamp_min(strike - spot, 0.0))
    return torch.where(maturity <= 0.0, intrinsic, val)


def vega(spot, strike, rate, dividend, maturity, vol):
    """dV/dsigma.  Matches src/cpp/models/heston.cpp:296-309."""
    spot, strike, maturity, vol = _broadcast(spot, strike, maturity, vol)
    ok = (maturity > 0.0) & (vol > 0.0)
    one = torch.ones_like(maturity)
    safe_T = torch.where(ok, maturity, one)
    safe_vol = torch.where(ok, vol, one)
    d1, _ = _d1_d2(spot, strike, rate, dividend, safe_T, safe_vol)
    v = spot * torch.exp(-dividend * safe_T) * torch.sqrt(safe_T) * norm_pdf(d1)
    return torch.where(ok, v, torch.zeros_like(v))


def _brenner_subrahmanyam_init(target, spot, strike, rate, dividend, maturity):
    """sigma ~ sqrt(2 pi / T) * P / S initial guess (data/options.py:260-320)."""
    approx = torch.sqrt(2.0 * math.pi / maturity) * target / spot
    del strike, rate, dividend
    return torch.clamp(approx, 0.05, 2.0)


def implied_vol(
    target_price,
    spot,
    strike,
    rate,
    dividend,
    maturity,
    is_call=True,
    init_vol=None,
    max_iter: int = 100,
    tol: float = 1e-8,
):
    """Vectorized Newton-Raphson implied volatility.

    Reproduces HestonModel::implied_volatility (src/cpp/models/heston.cpp:311-349):

    * when local vega < 1e-12 the vol is multiplied by 1.5 and iteration
      continues;
    * otherwise a damped Newton step clipped into [0.001, 5.0] is taken;
    * iteration stops (per element, via masking) once |BS - target| < tol.

    ``init_vol`` defaults to a Brenner-Subrahmanyam guess
    (data/options.py:260-320).
    """
    target_price, spot, strike, maturity = _broadcast(
        target_price, spot, strike, maturity)
    if init_vol is None:
        vol = _brenner_subrahmanyam_init(target_price, spot, strike, rate,
                                         dividend, maturity)
    else:
        vol = to_tensor(init_vol, target_price.dtype,
                        target_price.device).expand(target_price.shape)

    done = torch.zeros(target_price.shape, dtype=torch.bool,
                       device=target_price.device)
    for _ in range(max_iter):
        bs = price(spot, strike, rate, dividend, maturity, vol, is_call)
        vg = vega(spot, strike, rate, dividend, maturity, vol)
        diff = bs - target_price

        # damped Newton: cap each move at 2x — a barely-nonzero vega on
        # deep-OTM quotes makes the raw step explode into a 0.005 <-> 5.0
        # oscillation that never converges
        flat = vg < 1e-12
        raw = vol - diff / torch.where(flat, torch.ones_like(vg), vg)
        newton = torch.clamp(torch.minimum(torch.maximum(raw, 0.5 * vol),
                                           2.0 * vol), 0.001, 5.0)
        proposal = torch.where(flat, torch.clamp_max(vol * 1.5, 5.0), newton)

        done = done | (torch.abs(diff) < tol)
        vol = torch.where(done, vol, proposal)
    return torch.where(maturity <= 0.0, torch.zeros_like(vol), vol)
