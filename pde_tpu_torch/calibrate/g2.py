"""G2++ (a, b, sigma, eta, rho) calibration to a European swaption panel
(twin of ``pde_tpu/calibrate/g2.py``).

The curve is embedded exactly by construction (``models/g2.G2Params``),
so only the five dynamical parameters are free: a bounded
Levenberg-Marquardt over relative price residuals, each residual pricing
the panel through the Gauss-Hermite swaption formula (the LM's ``jacfwd``
tangents run through its fixed-trip Newton for the critical boundary).
The panel is ragged, so the residuals loop over its swaptions, as the
reference's do.

Runs on the card unless the caller passes ``device="cpu"``; the precision
is ``dtype``, else the quotes'.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..core.precision import resolve_device
from ..models import g2 as g2_mod
from ..models.g2 import G2Params
from ..models.rates import DiscountCurve
from .rates import _converter, _fit

__all__ = ["G2CalibrationResult", "G2Calibrator"]

# (a, b, sigma, eta, rho)
_LOWER = (1e-3, 1e-3, 1e-4, 1e-4, -0.99)
_UPPER = (3.0, 3.0, 0.10, 0.10, 0.99)


@dataclass
class G2CalibrationResult:
    params: G2Params
    rmse: float
    max_rel_error: float
    converged: bool
    n_iter: int


class G2Calibrator:
    """Fit the five G2++ parameters to swaption PRICES.

    ``expiries[i]``, ``pay_times[i]`` (each a strictly increasing array
    after the expiry), ``strikes[i]``, ``quotes[i]`` define one European
    swaption.  ``device`` and ``dtype`` as ``HullWhiteCalibrator``'s.
    """

    def __init__(self, max_iter: int = 80, x0=(0.5, 0.05, 0.01, 0.008, -0.5),
                 n_gh: int = 64, device=None, dtype: Optional[torch.dtype] = None):
        self.max_iter = int(max_iter)
        self.x0 = x0
        self.n_gh = int(n_gh)
        self.device = resolve_device(device)
        self.dtype = dtype

    def calibrate_swaptions(self, curve: DiscountCurve, expiries: Sequence[float],
                            pay_times: Sequence[Sequence[float]], strikes: Sequence[float],
                            quotes, payer: bool = True, x0=None) -> G2CalibrationResult:
        """``x0`` warm-starts from a previous fit (the orchestrator's
        convention)."""
        t = _converter(self.device, self.dtype, quotes)
        curve = DiscountCurve(t(curve.times), t(curve.dfs))
        expiries = [t(e) for e in expiries]
        pay_times = [t(pt) for pt in pay_times]
        strikes = [t(k) for k in strikes]
        quotes = t(quotes)

        def resid(v):
            # at least 1-d throughout, as calibrate/rates.py's residuals
            p = G2Params(*(v[i:i + 1] for i in range(5)), curve)
            model = torch.cat([g2_mod.g2_swaption(p, k[None], e[None], pt[None], payer=payer,
                                                  n_gh=self.n_gh)
                               for e, pt, k in zip(expiries, pay_times, strikes)])
            return (model - quotes) / torch.clamp_min(quotes, 1e-12)

        res, quality = _fit(resid, t(self.x0 if x0 is None else tuple(x0)), t(_LOWER),
                            t(_UPPER), self.max_iter)
        return G2CalibrationResult(G2Params(*res.x.unbind(0), curve), **quality)
