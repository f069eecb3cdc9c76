"""SABR model: Hagan et al. (2002) asymptotic implied volatility (twin of
``pde_tpu/models/sabr.py``).

One branch-free broadcasting expression: every conditional of the scalar
C++ (src/cpp/models/sabr.{hpp,cpp}) — the small-z Taylor branch of chi, the
ATM shortcut, the zero-maturity shortcut, the rho -> 1 limit — is a
``torch.where`` over guarded operands.  Forward-mode AD runs through both
sides of every ``where``, so the guards (``max(alpha, eps)``, the floored
chi numerator) are kept exactly: they keep the unselected side finite.
Functions follow their inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.precision import device_of, result_dtype, to_tensor, where_flag

__all__ = [
    "SABRParams",
    "implied_volatility",
    "implied_volatilities",
    "atm_volatility",
    "volatility_sensitivities",
    "volatility_smile",
]

_EPSILON = 1e-10  # numerical-comparison epsilon (sabr.cpp:12)
_ATM_THRESHOLD = 1e-6  # |log(F/K)| ATM cutoff (sabr.cpp:15)


class SABRParams(NamedTuple):
    """SABR parameters (alpha, beta, rho, nu): numbers or tensors."""

    alpha: torch.Tensor
    beta: torch.Tensor
    rho: torch.Tensor
    nu: torch.Tensor

    def validate(self) -> None:
        a, b, r, n = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                      for x in self)
        if np.any(a <= 0):
            raise ValueError("alpha must be positive")
        if np.any((b < 0) | (b > 1)):
            raise ValueError("beta must be in [0, 1]")
        if np.any(np.abs(r) >= 1):
            raise ValueError("|rho| must be < 1")
        if np.any(n < 0):
            raise ValueError("nu must be non-negative")


def _max(x, floor):
    """``max(x, floor)`` for a tensor or a number."""
    return torch.clamp_min(x, floor) if isinstance(x, torch.Tensor) else max(x, floor)


def _chi(z, rho):
    """chi(z) = ln((sqrt(1-2 rho z + z^2) + z - rho) / (1 - rho)), with the
    small-z third-order Taylor branch and the numerator floored at epsilon
    (SABRModel::chi_function, sabr.cpp:32-62)."""
    small = torch.abs(z) < _EPSILON
    taylor = z * (1.0 + 0.5 * rho * z + (2.0 * rho * rho - 1.0) / 6.0 * z * z)
    sqrt_term = torch.sqrt(torch.clamp_min(1.0 - 2.0 * rho * z + z * z, 0.0))
    numer = torch.clamp_min(sqrt_term + z - rho, _EPSILON)
    denom = 1.0 - rho
    if isinstance(denom, torch.Tensor):
        denom = torch.where(torch.abs(denom) < _EPSILON, _EPSILON, denom)
    elif abs(denom) < _EPSILON:
        denom = _EPSILON
    return torch.where(small, taylor, torch.log(numer / denom))


def _correction_factor(strike, forward, maturity, alpha, beta, rho, nu):
    """[1 + (term1 + term2 + term3) T]  (sabr.cpp:79-99)."""
    omb = 1.0 - beta
    fk_pow = torch.sqrt(forward * strike) ** omb
    term1 = (omb * omb / 24.0) * (alpha * alpha) / (fk_pow * fk_pow)
    term2 = (rho * beta * nu * alpha) / (4.0 * fk_pow)
    term3 = ((2.0 - 3.0 * rho * rho) / 24.0) * nu * nu
    return 1.0 + (term1 + term2 + term3) * maturity


def atm_volatility(forward, maturity, params: SABRParams):
    """Hagan Eq. 2.18 ATM volatility (sabr.cpp:101-144)."""
    alpha, beta, rho, nu = params
    omb = 1.0 - beta
    f_pow = forward ** omb
    base = alpha / f_pow
    term1 = (omb * omb / 24.0) * alpha * alpha / (f_pow * f_pow)
    term2 = (rho * beta * nu * alpha) / (4.0 * f_pow)
    term3 = ((2.0 - 3.0 * rho * rho) / 24.0) * nu * nu
    return base * (1.0 + (term1 + term2 + term3) * maturity)


def implied_volatility(strike, forward, maturity, params: SABRParams):
    """Hagan Eq. 2.17a lognormal implied vol; broadcasts over all inputs.

    The branch structure of SABRModel::implied_volatility (sabr.cpp:146-216):
    zero-maturity shortcut, ATM shortcut at |log(F/K)| < 1e-6, otherwise the
    full formula with the 1/24 + 1/1920 log-moneyness series and z/chi(z).
    """
    alpha, beta, rho, nu = params
    rdt = result_dtype(strike, forward, maturity, alpha)
    device = device_of(strike, forward, maturity, alpha, beta, rho, nu)
    strike = to_tensor(strike, rdt, device)
    forward = to_tensor(forward, rdt, device)
    maturity = to_tensor(maturity, rdt, device)

    omb = 1.0 - beta
    log_fk = torch.log(forward / strike)
    fk_pow = torch.sqrt(forward * strike) ** omb

    # z and chi(z)   (sabr.cpp:64-77)
    z = (nu / _max(alpha, _EPSILON)) * fk_pow * log_fk
    z = where_flag((nu < _EPSILON) | (alpha < _EPSILON), torch.zeros_like(z), z)
    z_over_chi = torch.where(torch.abs(z) < _EPSILON, 1.0, z / _chi(z, rho))

    log_fk_sq = log_fk * log_fk
    series = (1.0 + (omb * omb / 24.0) * log_fk_sq
              + (omb ** 4 / 1920.0) * log_fk_sq * log_fk_sq)
    sigma_base = (alpha / (fk_pow * series)) * z_over_chi
    non_atm = sigma_base * _correction_factor(strike, forward, maturity, alpha,
                                              beta, rho, nu)

    atm = atm_volatility(forward, maturity, params)
    vol = torch.where(torch.abs(log_fk) < _ATM_THRESHOLD, atm, non_atm)

    # zero maturity: instantaneous vol alpha / (F K)^((1-beta)/2)  (sabr.cpp:169-173)
    return torch.where(maturity < _EPSILON, alpha / fk_pow, vol)


def implied_volatilities(strikes, forward, maturity, params: SABRParams):
    """Vectorized smile (the OpenMP loop of sabr.cpp:218-231 as one tensor op)."""
    return implied_volatility(strikes, forward, maturity, params)


def volatility_sensitivities(strike, forward, maturity, params: SABRParams):
    """(d sigma/d alpha, d sigma/d rho, d sigma/d nu) by forward-mode AD
    (the reference takes central finite differences, sabr.cpp:250-280)."""
    rdt = result_dtype(strike, forward, maturity, params.alpha)
    device = device_of(strike, forward, maturity, *params)

    def vol(alpha, rho, nu):
        return implied_volatility(strike, forward, maturity,
                                  SABRParams(alpha, params.beta, rho, nu))

    # (1,)-shaped, not 0-d: under jacfwd a 0-d tensor times a Python number
    # gets a float64 tangent whatever the working dtype
    args = tuple(to_tensor(a, rdt, device).reshape(1)
                 for a in (params.alpha, params.rho, params.nu))
    return tuple(d[..., 0] for d in torch.func.jacfwd(vol, argnums=(0, 1, 2))(*args))


def volatility_smile(strikes, forward, maturity, params: SABRParams):
    """Alias matching models/sabr.py:291 in the reference."""
    return implied_volatilities(strikes, forward, maturity, params)
