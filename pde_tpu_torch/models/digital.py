r"""Digital (binary) option pricing under affine characteristic functions
(twin of ``pde_tpu/models/digital.py``).

Cash-or-nothing and asset-or-nothing digitals by Gil-Pelaez Fourier
inversion, in the forward-moneyness form of the vanilla quadrature
(models/heston.py): the integrand's only phase is the small
exp(i u ln(F/K)), so float32/complex64 runs on the card keep full relative
precision.  Works for any params type that ``heston._cf_reduced`` takes:
Heston, Bates and the other ``cf_reduced_extra`` extensions.

With phi(u) = cf_reduced(u) * exp(iu (ln S0 + (r-q)T)) and the martingale
normalization cf_reduced(-i) = 1, the money- and share-measure exercise
probabilities are

  P_j = 1/2 + (1/pi) \int_0^inf Re[ cf_reduced(u - i*[j==1]) e^{iu x} / (iu) ] du,
  x = ln(F/K)

and the prices

  cash-or-nothing  call/put:  e^{-rT} P2          /  e^{-rT} (1 - P2)
  asset-or-nothing call/put:  S0 e^{-qT} P1       /  S0 e^{-qT} (1 - P1)

with the European decomposition C = asset_call - K * cash_call.
"""

from __future__ import annotations

import math

import torch

from ..core.precision import complex_dtype_for, device_of, result_dtype, to_tensor
from .heston import _accurate_gl_rule, _cf_reduced


def _tail_scale(params, T, rdt):
    """Per-contract quadrature stretch for short-dated / low-variance tails.

    The Gil-Pelaez integrand decays like |cf(u)|/u, and the CF's decay scale
    is ~1/sqrt(integrated variance): for short maturities or low variance
    the tail at u = 204.8 is not negligible.  Substitute u = s * v with
    s = sqrt(0.04 / vbar) clipped to [1, 8], vbar the Heston integrated
    variance ``theta T + (v0 - theta)(1 - e^{-kappa T})/kappa``.  The 1/(iu)
    kernel absorbs the Jacobian.  Detached: the scale is a quadrature
    choice (d(integral)/ds = 0 analytically), so it must not feed
    discretization noise into AD Greeks.  Params without kappa/theta/v0
    keep scale 1.
    """
    kappa = getattr(params, "kappa", None)
    theta = getattr(params, "theta", None)
    v0 = getattr(params, "v0", None)
    if kappa is None or theta is None or v0 is None:
        return torch.ones_like(T, dtype=rdt)
    kappa, theta, v0 = (to_tensor(x, rdt, T.device) for x in (kappa, theta, v0))
    k_safe = torch.clamp_min(kappa, 1e-6)
    vbar = theta * T + (v0 - theta) * (-torch.expm1(-k_safe * T)) / k_safe
    s = torch.sqrt(0.04 / torch.clamp_min(vbar, 1e-10))
    return torch.clamp(s, 1.0, 8.0).detach()


def _flag(is_call, like):
    """``is_call`` broadcast to ``like``'s shape as a bool tensor on its device."""
    return torch.as_tensor(is_call, device=like.device).to(torch.bool).expand(like.shape)


def _gl(n_per_panel, rdt, device):
    v_np, w_np = _accurate_gl_rule(n_per_panel)
    return to_tensor(v_np, rdt, device), to_tensor(w_np, rdt, device)


def _gil_pelaez_probs(params, strike, maturity, spot, rate, dividend,
                      n_per_panel, kind: str = "both"):
    """(P1, P2) by Gil-Pelaez.  ``kind`` selects the contour(s): 'cash'
    needs only cf(u) (P2), 'asset' only cf(u-i) (P1), 'both' both; the
    skipped probability returns as None."""
    rdt = result_dtype(strike, maturity, spot)
    cdt = complex_dtype_for(rdt)
    device = device_of(strike, maturity, spot)
    strike, T = torch.broadcast_tensors(to_tensor(strike, rdt, device),
                                        to_tensor(maturity, rdt, device))
    spot = to_tensor(spot, rdt, device)
    v, w = _gl(n_per_panel, rdt, device)

    x = (torch.log(spot / strike) + (rate - dividend) * T)[..., None]
    Tn = T[..., None]
    s = _tail_scale(params, T, rdt)[..., None]
    u = (v * s).to(cdt)              # stretched nodes, (..., n)

    # the 1/(iu) kernel absorbs the substitution Jacobian: (w s)/(i v s) =
    # w/(i v); only the CF argument and the phase carry the stretch
    one = torch.ones((), dtype=cdt, device=device)
    kern = torch.exp(1j * u * x.to(cdt)) * (-1j / v)

    def prob(cf):
        # T <= 0: the reduced CF is exp(0) = 1; guard 0/0 NaNs there
        cf = torch.where(Tn <= 0.0, one, cf)
        return torch.clamp(0.5 + torch.sum(w * (cf * kern).real, dim=-1) / math.pi,
                           0.0, 1.0)

    p1 = p2 = None
    if kind in ("cash", "both"):
        p2 = prob(_cf_reduced(params, u, Tn, rdt, cdt))
    if kind in ("asset", "both"):
        p1 = prob(_cf_reduced(params, u - 1j, Tn, rdt, cdt))
    return p1, p2, strike, T, spot, rdt


def probabilities(params, strike, maturity, spot, rate=0.0, dividend=0.0,
                  n_per_panel: int = 40):
    """(P1, P2): share- and money-measure exercise probabilities
    Q_S(S_T > K), Q(S_T > K) by Gil-Pelaez on the composite GL rule
    (``heston._accurate_gl_rule``).  Broadcasts over strike/maturity."""
    p1, p2, *_ = _gil_pelaez_probs(params, strike, maturity, spot, rate, dividend,
                                   n_per_panel)
    return p1, p2


def prices_from_probs(p1, p2, strike, maturity, spot, rate=0.0, dividend=0.0,
                      is_call=True):
    """(cash, asset) digital prices from ONE :func:`probabilities` result,
    so the two CF contours are evaluated once."""
    dt, device = p2.dtype, p2.device
    T = to_tensor(maturity, dt, device).expand(p2.shape)
    call = _flag(is_call, p2)
    df_r = torch.exp(-to_tensor(rate, dt, device) * T)
    df_q = to_tensor(spot, dt, device) * torch.exp(-to_tensor(dividend, dt, device) * T)
    cash = df_r * torch.where(call, p2, 1.0 - p2)
    asset = df_q * torch.where(call, p1, 1.0 - p1)
    return cash, asset


def _check_kind(kind):
    if kind not in ("cash", "asset"):
        raise ValueError(f"kind must be 'cash' or 'asset', got {kind!r}")


def price(params, strike, maturity, spot, rate=0.0, dividend=0.0,
          is_call=True, kind: str = "cash", n_per_panel: int = 40):
    """Digital option price.

    ``kind="cash"`` pays 1 at expiry in the money (``e^{-rT} P2`` /
    ``e^{-rT}(1-P2)``); ``kind="asset"`` pays S_T (``S0 e^{-qT} P1`` /
    ``S0 e^{-qT}(1-P1)``).  ``is_call`` may be a tensor (broadcasts).  Only
    the contour the kind needs is evaluated.
    """
    _check_kind(kind)
    p1, p2, _, T, spot_a, rdt = _gil_pelaez_probs(
        params, strike, maturity, spot, rate, dividend, n_per_panel, kind=kind)
    if kind == "cash":
        return torch.exp(-to_tensor(rate, rdt, T.device) * T) * torch.where(
            _flag(is_call, p2), p2, 1.0 - p2)
    return spot_a * torch.exp(-to_tensor(dividend, rdt, T.device) * T) * torch.where(
        _flag(is_call, p1), p1, 1.0 - p1)


def _gil_pelaez_probs_grouped(params, strikes, t_idx, unique_T, spot, rate,
                              dividend, n_per_panel, kind: str = "both"):
    """(P1, P2) with the CF rows SHARED per unique maturity (one row per
    contour per maturity), as ``heston._carr_madan_grouped_sum`` shares
    them: an N-option book with M maturities costs (1 or 2)*M*n CF
    evaluations.  The tail stretch (:func:`_tail_scale`) applies per
    maturity row."""
    rdt = result_dtype(strikes, unique_T, spot)
    cdt = complex_dtype_for(rdt)
    device = device_of(strikes, unique_T, spot)
    strikes = to_tensor(strikes, rdt, device)
    uT = to_tensor(unique_T, rdt, device)
    spot = to_tensor(spot, rdt, device)
    t_idx = torch.as_tensor(t_idx, device=device).long()
    v, w = _gl(n_per_panel, rdt, device)

    Tm = uT[:, None]                                  # (M, 1)
    vs = v[None, :] * _tail_scale(params, uT, rdt)[:, None]   # (M, n)
    u = vs.to(cdt)
    one = torch.ones((), dtype=cdt, device=device)
    # the GL weight and the 1/(iu) kernel folded into the maturity rows
    scale = (w / v).to(cdt) * (-1j)

    T = uT[t_idx]
    x = torch.log(spot / strikes) + (rate - dividend) * T
    vx = vs[t_idx] * x[..., None]                     # (..., n) per-option phase
    cos_vx, sin_vx = torch.cos(vx), torch.sin(vx)

    def prob(cf):
        g = (torch.where(Tm <= 0.0, one, cf) * scale)[t_idx]
        return torch.clamp(0.5 + torch.sum(g.real * cos_vx - g.imag * sin_vx, dim=-1)
                           / math.pi, 0.0, 1.0)

    p1 = p2 = None
    if kind in ("cash", "both"):
        p2 = prob(_cf_reduced(params, u, Tm, rdt, cdt))
    if kind in ("asset", "both"):
        p1 = prob(_cf_reduced(params, u - 1j, Tm, rdt, cdt))
    return p1, p2, strikes, T, spot, rdt


def price_grouped(params, strikes, t_idx, unique_T, spot, rate=0.0,
                  dividend=0.0, is_call=True, kind: str = "cash",
                  n_per_panel: int = 40):
    """:func:`price` with the CF shared per unique maturity: digital books
    as flat chain vectors with a ``group_maturities`` index."""
    _check_kind(kind)
    p1, p2, _, T, spot_a, rdt = _gil_pelaez_probs_grouped(
        params, strikes, t_idx, unique_T, spot, rate, dividend, n_per_panel, kind=kind)
    if kind == "cash":
        return torch.exp(-to_tensor(rate, rdt, T.device) * T) * torch.where(
            _flag(is_call, p2), p2, 1.0 - p2)
    return spot_a * torch.exp(-to_tensor(dividend, rdt, T.device) * T) * torch.where(
        _flag(is_call, p1), p1, 1.0 - p1)


def european_from_digitals(params, strike, maturity, spot, rate=0.0,
                           dividend=0.0, is_call=True, n_per_panel: int = 40):
    """Vanilla European price from the two digitals: ``C = asset_call -
    K * cash_call`` (put by the complements), both contours from one
    Gil-Pelaez pass."""
    p1, p2, strike_b, *_ = _gil_pelaez_probs(
        params, strike, maturity, spot, rate, dividend, n_per_panel, kind="both")
    cash, asset = prices_from_probs(p1, p2, strike_b, maturity, spot, rate, dividend,
                                    is_call=is_call)
    k = to_tensor(strike, asset.dtype, asset.device)
    return torch.where(_flag(is_call, asset), asset - k * cash, k * cash - asset)
