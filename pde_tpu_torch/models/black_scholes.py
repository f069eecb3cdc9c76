"""Black-Scholes closed forms, Greeks, barrier, digital and touch prices,
and vectorized implied volatility (twin of
``pde_tpu/models/black_scholes.py``).

Every function broadcasts over its arguments and runs on its tensor
inputs' device (the card for plain numbers); the IV solver is a
fixed-iteration masked Newton loop, so it needs no host read per step.
Reference semantics: src/cpp/models/heston.cpp:275-349 and
data/options.py:118-455.
"""

from __future__ import annotations

import math

import torch

from ..core.precision import device_of, result_dtype, to_tensor, where_flag
from ..utils.stats import norm_cdf, norm_pdf

__all__ = [
    "price",
    "vega",
    "delta",
    "gamma",
    "theta",
    "rho",
    "greeks",
    "implied_vol",
    "barrier_price",
    "digital_price",
    "no_touch_prob",
    "touch_price",
]


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


def _sign(flag, like: torch.Tensor) -> torch.Tensor:
    """+1 where ``flag`` (a call) holds, -1 elsewhere, as ``like``'s type."""
    one = torch.ones_like(like)
    return where_flag(flag, one, -one)


def delta(spot, strike, rate, dividend, maturity, vol, is_call=True):
    spot, strike, maturity, vol = _broadcast(spot, strike, maturity, vol)
    d1, _ = _d1_d2(spot, strike, rate, dividend, maturity, vol)
    dq = torch.exp(-dividend * maturity)
    return where_flag(is_call, dq * norm_cdf(d1), dq * (norm_cdf(d1) - 1.0))


def gamma(spot, strike, rate, dividend, maturity, vol):
    spot, strike, maturity, vol = _broadcast(spot, strike, maturity, vol)
    d1, _ = _d1_d2(spot, strike, rate, dividend, maturity, vol)
    return torch.exp(-dividend * maturity) * norm_pdf(d1) / (spot * vol * torch.sqrt(maturity))


def theta(spot, strike, rate, dividend, maturity, vol, is_call=True):
    """Calendar theta (per year).  Reference: data/options.py BS Greeks."""
    spot, strike, maturity, vol = _broadcast(spot, strike, maturity, vol)
    d1, d2 = _d1_d2(spot, strike, rate, dividend, maturity, vol)
    dq = torch.exp(-dividend * maturity)
    dr = torch.exp(-rate * maturity)
    decay = -spot * dq * norm_pdf(d1) * vol / (2.0 * torch.sqrt(maturity))
    call = decay - rate * strike * dr * norm_cdf(d2) + dividend * spot * dq * norm_cdf(d1)
    put = decay + rate * strike * dr * norm_cdf(-d2) - dividend * spot * dq * norm_cdf(-d1)
    return where_flag(is_call, call, put)


def rho(spot, strike, rate, dividend, maturity, vol, is_call=True):
    spot, strike, maturity, vol = _broadcast(spot, strike, maturity, vol)
    _, d2 = _d1_d2(spot, strike, rate, dividend, maturity, vol)
    dr = torch.exp(-rate * maturity)
    return where_flag(is_call, strike * maturity * dr * norm_cdf(d2),
                      -strike * maturity * dr * norm_cdf(-d2))


def greeks(spot, strike, rate, dividend, maturity, vol, is_call=True):
    """All first/second-order BS Greeks as a dict of broadcast tensors."""
    return {
        "delta": delta(spot, strike, rate, dividend, maturity, vol, is_call),
        "gamma": gamma(spot, strike, rate, dividend, maturity, vol),
        "vega": vega(spot, strike, rate, dividend, maturity, vol),
        "theta": theta(spot, strike, rate, dividend, maturity, vol, is_call),
        "rho": rho(spot, strike, rate, dividend, maturity, vol, is_call),
    }


def barrier_price(spot, strike, barrier, rate, dividend, maturity, vol,
                  barrier_type: str = "up-and-out", is_call=True):
    """Continuously monitored single-barrier option (Reiner-Rubinstein 1991).

    Zero rebate.  ``barrier_type`` is one of up/down-and-in/out, checked
    on the host; all model arguments broadcast.  Options already beyond the
    barrier at t=0 are treated as knocked (out -> 0, in -> vanilla).
    """
    direction, _, inout = barrier_type.partition("-and-")
    if direction not in ("up", "down") or inout not in ("in", "out"):
        raise ValueError(f"unknown barrier_type {barrier_type!r}")

    S, K, B, T, sig = _broadcast(spot, strike, barrier, maturity, vol)
    phi = _sign(is_call, S)
    eta = 1.0 if direction == "down" else -1.0

    vs = sig * torch.sqrt(T)
    mu = (rate - dividend) / (sig * sig) - 0.5
    df_r = torch.exp(-rate * T)
    df_q = torch.exp(-dividend * T)

    x1 = torch.log(S / K) / vs + (1.0 + mu) * vs
    x2 = torch.log(S / B) / vs + (1.0 + mu) * vs
    y1 = torch.log(B * B / (S * K)) / vs + (1.0 + mu) * vs
    y2 = torch.log(B / S) / vs + (1.0 + mu) * vs
    pow1 = (B / S) ** (2.0 * (mu + 1.0))
    pow2 = (B / S) ** (2.0 * mu)

    def _plain(x):
        return phi * S * df_q * norm_cdf(phi * x) - phi * K * df_r * norm_cdf(phi * (x - vs))

    def _refl(y):
        return (phi * S * df_q * pow1 * norm_cdf(eta * y)
                - phi * K * df_r * (pow2 * norm_cdf(eta * (y - vs))))

    A, Bv, C, D = _plain(x1), _plain(x2), _refl(y1), _refl(y2)

    k_above = K > B  # strike above the barrier level
    if direction == "down":
        in_val = where_flag(is_call, torch.where(k_above, C, A - Bv + D),
                            torch.where(k_above, Bv - C + D, A))
    else:
        in_val = where_flag(is_call, torch.where(k_above, A, Bv - C + D),
                            torch.where(k_above, A - Bv + D, C))

    vanilla = price(S, K, rate, dividend, T, sig, is_call)
    in_val = torch.minimum(torch.clamp_min(in_val, 0.0), vanilla)
    knocked = (S >= B) if direction == "up" else (S <= B)
    in_val = torch.where(knocked, vanilla, in_val)
    if inout == "in":
        return in_val
    return vanilla - in_val


def digital_price(spot, strike, rate, dividend, maturity, vol, is_call=True,
                  kind: str = "cash"):
    """Digital (binary) option closed form.

    ``kind="cash"`` pays 1 at expiry if in the money: ``e^{-rT} N(+-d2)``;
    ``kind="asset"`` pays S_T: ``S e^{-qT} N(+-d1)``.
    """
    if kind not in ("cash", "asset"):
        raise ValueError(f"kind must be 'cash' or 'asset', got {kind!r}")
    spot, strike, maturity, vol = _broadcast(spot, strike, maturity, vol)
    d1, d2 = _d1_d2(spot, strike, rate, dividend, maturity, vol)
    sign = _sign(is_call, d1)
    if kind == "cash":
        return torch.exp(-rate * maturity) * norm_cdf(sign * d2)
    return spot * torch.exp(-dividend * maturity) * norm_cdf(sign * d1)


def no_touch_prob(spot, barrier, rate, dividend, maturity, vol):
    """Risk-neutral probability that the GBM path never touches ``barrier``
    on [0, T] (continuous monitoring), by the reflection principle; with
    nu = r - q - vol^2/2, b = ln(B/S0) and s = vol sqrt(T):

      up   (b > 0):  N((b - nu T)/s) - e^{2 nu b / vol^2} N((-b - nu T)/s)
      down (b < 0):  N((nu T - b)/s) - e^{2 nu b / vol^2} N((b + nu T)/s)

    A barrier already touched at t=0 gives 0.
    """
    S, B, T, sig = _broadcast(spot, barrier, maturity, vol)
    nu = rate - dividend - 0.5 * sig * sig
    b = torch.log(B / S)
    s = sig * torch.sqrt(T)
    refl = torch.exp(2.0 * nu * b / (sig * sig))
    p_up = norm_cdf((b - nu * T) / s) - refl * norm_cdf((-b - nu * T) / s)
    p_down = norm_cdf((nu * T - b) / s) - refl * norm_cdf((b + nu * T) / s)
    p = torch.where(b > 0.0, p_up, p_down)
    return torch.clamp(torch.where(b == 0.0, torch.zeros_like(p), p), 0.0, 1.0)


def touch_price(spot, barrier, rate, dividend, maturity, vol, touch: bool = True):
    """One-touch (``touch=True``) / no-touch cash digital paying 1 at expiry,
    continuously monitored: ``e^{-rT} P(hit)`` / ``e^{-rT} P(no hit)``."""
    p_no = no_touch_prob(spot, barrier, rate, dividend, maturity, vol)
    p = 1.0 - p_no if touch else p_no
    return torch.exp(-rate * to_tensor(maturity, p.dtype, p.device)) * p


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
