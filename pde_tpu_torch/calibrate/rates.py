"""Hull-White (a, sigma) calibration to cap/swaption quotes (twin of
``pde_tpu/calibrate/rates.py``).

The market discount curve is fitted exactly by construction
(``models/rates.HullWhiteParams`` embeds it), so only the two dynamical
parameters remain: a bounded Levenberg-Marquardt (``calibrate/lm.py``,
``jacfwd`` tangents) over relative price residuals of the instrument
strip.  The caplet strip prices in one broadcast call; the swaption panel
is ragged (each swaption its own pay dates), so its residuals loop over
the swaptions, as the reference's do.

Runs on the card unless the caller passes ``device="cpu"``; the precision
is ``dtype``, else the quotes' (a float tensor's dtype, torch's default
float for numbers and arrays).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.precision import resolve_device, result_dtype
from ..models import rates
from ..models.rates import DiscountCurve, HullWhiteParams
from .lm import levenberg_marquardt

__all__ = ["HullWhiteCalibrationResult", "HullWhiteCalibrator"]

_LOWER = (1e-3, 1e-4)   # (a, sigma)
_UPPER = (3.0, 0.10)


@dataclass
class HullWhiteCalibrationResult:
    params: HullWhiteParams
    rmse: float
    max_rel_error: float
    converged: bool
    n_iter: int


# The residuals keep every tensor they compute at least 1-d: parameters
# (1,)-shaped, each swaption a panel of one.  Under the LM's
# vmap(jacfwd), a 0-d tangent times a Python number comes out float64,
# which would leave a float32 fit with a float64 Jacobian.


def _caplet_residuals(x, curve, starts, ends, strikes, quotes):
    p = HullWhiteParams(x[0:1], x[1:2], curve)
    model = rates.hw_caplet(p, strikes, starts, ends)
    return (model - quotes) / torch.clamp_min(quotes, 1e-12)


def _swaption_residuals(x, curve, expiries, pay_times, strikes, quotes):
    p = HullWhiteParams(x[0:1], x[1:2], curve)
    model = torch.cat([rates.hw_swaption(p, k[None], e[None], pt[None])
                       for e, pt, k in zip(expiries, pay_times, strikes)])
    return (model - quotes) / torch.clamp_min(quotes, 1e-12)


def _converter(device, dtype, quotes):
    """Values (numbers, arrays, tensors) as tensors on ``device`` in
    ``dtype``, else in the quotes' precision."""
    dtype = dtype or result_dtype(quotes)
    return lambda v: torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v),
                                     dtype=dtype, device=device)


def _fit(resid, x0, lower, upper, max_iter):
    """The LM fit and its fit quality: (LM result, dict of rmse,
    max_rel_error, converged and n_iter read on the host)."""
    res = levenberg_marquardt(resid, x0, lower, upper, max_iter=max_iter)
    r = resid(res.x).detach().cpu().numpy().astype(np.float64)
    return res, dict(rmse=float(np.sqrt(np.mean(r * r))), max_rel_error=float(np.max(np.abs(r))),
                     converged=bool(res.converged), n_iter=int(res.n_iter))


class HullWhiteCalibrator:
    """Fit ``(a, sigma)`` to a caplet strip and/or a swaption panel.

    Quotes are PRICES (undiscounted premia in curve units).  Vol-quoted
    markets convert via their Black/Bachelier convention first (the
    reference's price-space objective, relative-error least squares).
    ``device`` and ``dtype`` set where and in which precision the fit runs
    (default: the CUDA card, the quotes' precision).
    """

    def __init__(self, max_iter: int = 60, x0: Tuple[float, float] = (0.1, 0.01),
                 device=None, dtype: Optional[torch.dtype] = None):
        self.max_iter = int(max_iter)
        self.x0 = x0
        self.device = resolve_device(device)
        self.dtype = dtype

    def calibrate_caplets(self, curve: DiscountCurve, starts, ends, strikes, quotes,
                          x0: Optional[Tuple[float, float]] = None
                          ) -> HullWhiteCalibrationResult:
        """``x0`` warm-starts the LM from a previous fit (the orchestrator
        passes yesterday's (a, sigma))."""
        t = _converter(self.device, self.dtype, quotes)
        curve = DiscountCurve(t(curve.times), t(curve.dfs))
        starts, ends, strikes, quotes = (t(v) for v in (starts, ends, strikes, quotes))
        res, quality = _fit(
            lambda x: _caplet_residuals(x, curve, starts, ends, strikes, quotes),
            t(self.x0 if x0 is None else tuple(x0)), t(_LOWER), t(_UPPER), self.max_iter)
        return HullWhiteCalibrationResult(HullWhiteParams(res.x[0], res.x[1], curve), **quality)

    def calibrate_swaptions(self, curve: DiscountCurve, expiries: Sequence[float],
                            pay_times: Sequence[Sequence[float]], strikes: Sequence[float],
                            quotes, x0: Optional[Tuple[float, float]] = None
                            ) -> HullWhiteCalibrationResult:
        t = _converter(self.device, self.dtype, quotes)
        curve = DiscountCurve(t(curve.times), t(curve.dfs))
        expiries = [t(e) for e in expiries]
        pay_times = [t(pt) for pt in pay_times]
        strikes = [t(k) for k in strikes]
        quotes = t(quotes)
        res, quality = _fit(
            lambda x: _swaption_residuals(x, curve, expiries, pay_times, strikes, quotes),
            t(self.x0 if x0 is None else tuple(x0)), t(_LOWER), t(_UPPER), self.max_iter)
        return HullWhiteCalibrationResult(HullWhiteParams(res.x[0], res.x[1], curve), **quality)
