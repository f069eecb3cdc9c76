"""Bates (1996) stochastic-volatility jump-diffusion model, the Fourier
half (twin of ``pde_tpu/models/bates.py``).

Heston dynamics plus lognormal Merton-style jumps:

    dS/S = (r - q - lambda * kbar) dt + sqrt(v) dW_S + (e^J - 1) dN
    dv   = kappa (theta - v) dt + sigma sqrt(v) dW_v,   d<W_S, W_v> = rho dt

with ``N`` a Poisson process of intensity ``lambda`` and jump sizes
``J = ln(1 + jump)`` i.i.d. ``N(mu_j, sigma_j^2)``; the compensator
``kbar = E[e^J] - 1 = exp(mu_j + sigma_j^2 / 2) - 1`` keeps the discounted
spot a martingale.

The jumps enter the characteristic function as a factor that is 1 at
``u = -i``, so :class:`BatesParams` prices through every pricer of
:mod:`pde_tpu_torch.models.heston` by its ``cf_reduced_extra`` hook; this
module adds no quadrature.  Its fields may be numbers or tensors of one
shape, or of shapes that broadcast, as ``(P, 1, 1)`` fields price a
population of P parameter sets against the pricers' ``(M, n_u)`` rows.

The Monte Carlo names of the reference (``simulate_qe``,
``simulate_qe_paths``, ``price_*_mc``) come with the port's Monte Carlo
module.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.precision import device_of, result_dtype, to_tensor
from . import heston as heston_model
from .heston import HestonParams, _host

__all__ = [
    "BatesParams",
    "price_carr_madan_gl",
    "price_carr_madan_gl_grouped",
    "price_accurate",
    "price_accurate_grouped",
    "price_fft",
    "implied_volatility",
    "implied_volatility_grouped",
    "merton_reference_price",
]


def _exp(x):
    """exp of a tensor, or of a plain number as a plain number."""
    return torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)


class BatesParams(NamedTuple):
    """Bates parameters: the Heston five plus (lam, mu_j, sigma_j).

    ``lam`` is the jump intensity (jumps/year), ``mu_j`` and ``sigma_j`` the
    mean and standard deviation of the log jump size ``ln(1 + jump)``.
    ``lam = 0`` reduces exactly to :class:`HestonParams`.
    """

    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    rho: torch.Tensor
    v0: torch.Tensor
    lam: torch.Tensor
    mu_j: torch.Tensor
    sigma_j: torch.Tensor

    # -- the affine-extension hook (heston._extra) --------------------------
    def cf_reduced_extra(self, u, T, rdt, cdt):
        """Compensated jump CF factor exp(lam*T*(Phi_J(u) - 1) - i*u*lam*kbar*T),
        ``Phi_J(u) = exp(i u mu_j - u^2 sigma_j^2 / 2)``; 1 at ``u = -i``."""
        lam, mu_j, sj = (to_tensor(x, rdt, u.device) for x in (self.lam, self.mu_j,
                                                                self.sigma_j))
        kbar = torch.exp(mu_j + 0.5 * sj * sj) - 1.0
        phi_j = torch.exp(1j * u * mu_j - 0.5 * (u * u) * (sj * sj))
        return torch.exp(lam * T * (phi_j - 1.0) - 1j * u * (lam * kbar) * T)

    # -- the quadratic-variation hooks (models/varswap.py) ------------------
    def qv_rate_extra(self):
        """Expected jump quadratic variation per year: lam * (mu_j^2 + sigma_j^2)."""
        return self.lam * (self.mu_j * self.mu_j + self.sigma_j * self.sigma_j)

    def _jump_fields(self, s):
        return (to_tensor(x, s.dtype, s.device) for x in (self.lam, self.mu_j, self.sigma_j))

    def qv_laplace_extra(self, s, T):
        """Laplace transform of the jump QV sum_{k<=N_T} J_k^2: the compound
        Poisson exp(lam T (E[e^{-s J^2}] - 1)) with E[e^{-s J^2}] =
        exp(-s mu_j^2/(1+2 s sigma_j^2)) / sqrt(1 + 2 s sigma_j^2)."""
        lam, mu_j, sj = self._jump_fields(s)
        denom = 1.0 + 2.0 * s * sj * sj
        ej2 = torch.exp(-s * mu_j * mu_j / denom) / torch.sqrt(denom)
        return torch.exp(lam * T * (ej2 - 1.0))

    def qv_log_laplace_extra(self, s, T):
        """log of :meth:`qv_laplace_extra`, with ``E[e^{-s J^2}] - 1`` by
        ``expm1`` so the s -> 0 limit keeps full precision in float32."""
        lam, mu_j, sj = self._jump_fields(s)
        q = 2.0 * s * sj * sj
        log_ej2 = -s * mu_j * mu_j / (1.0 + q) - 0.5 * torch.log1p(q)
        return lam * T * torch.expm1(log_ej2)

    # -- conveniences --------------------------------------------------------
    def heston(self) -> HestonParams:
        """The diffusion part (drops the jump parameters)."""
        return HestonParams(self.kappa, self.theta, self.sigma, self.rho, self.v0)

    @property
    def mean_jump(self):
        """kbar = E[e^J] - 1, the expected relative jump size."""
        return _exp(self.mu_j + 0.5 * self.sigma_j ** 2) - 1.0

    def feller_value(self):
        return 2.0 * self.kappa * self.theta - self.sigma**2

    def feller_satisfied(self):
        return self.feller_value() >= 0.0

    def validate(self) -> None:
        """Host-side validation (raises ValueError like the reference)."""
        self.heston().validate()
        if np.any(_host(self.lam) < 0):
            raise ValueError("jump intensity lam must be non-negative")
        if np.any(_host(self.sigma_j) <= 0):
            raise ValueError("jump volatility sigma_j must be positive")

    def to_array(self) -> torch.Tensor:
        """The fields broadcast together and stacked on a new last axis, on
        their tensors' device (the card for plain numbers)."""
        rdt, device = result_dtype(*self), device_of(*self)
        return torch.stack(torch.broadcast_tensors(
            *(to_tensor(x, rdt, device) for x in self)), dim=-1)

    @classmethod
    def from_array(cls, arr):
        return cls(*(arr[..., i] for i in range(8)))


# the Heston pricers take BatesParams through the hook; re-exported so call
# sites read naturally
price_carr_madan_gl = heston_model.price_carr_madan_gl
price_carr_madan_gl_grouped = heston_model.price_carr_madan_gl_grouped
price_accurate = heston_model.price_accurate
price_accurate_grouped = heston_model.price_accurate_grouped
price_fft = heston_model.price_fft
implied_volatility = heston_model.implied_volatility
implied_volatility_grouped = heston_model.implied_volatility_grouped


def merton_reference_price(
    strike, maturity, spot, rate, dividend, bs_vol, lam, mu_j, sigma_j,
    is_call=True, n_terms=40,
):
    """Merton (1976) jump-diffusion series price: an independent float64
    oracle for the jump machinery, in numpy and scipy on the host.

    Conditioning on ``n`` jumps, the price is a Poisson-weighted sum of
    Black-Scholes prices with adjusted rate and variance.  With the Heston
    diffusion degenerate (``sigma -> 0``, ``v0 = theta = bs_vol^2``) the
    Bates CF price must match this series.
    """
    from scipy.stats import norm

    strike = np.asarray(strike, dtype=np.float64)
    tau = float(maturity)
    kbar = np.exp(mu_j + 0.5 * sigma_j**2) - 1.0
    lamp = lam * (1.0 + kbar)  # lambda' of the Merton series
    total = np.zeros_like(strike, dtype=np.float64)
    log_pn = -lamp * tau  # log Poisson(lambda' tau) weight, n = 0
    for n in range(n_terms):
        if n > 0:
            log_pn += np.log(lamp * tau) - np.log(n)
        sig_n = np.sqrt(bs_vol**2 + n * sigma_j**2 / tau)
        r_n = rate - lam * kbar + n * (mu_j + 0.5 * sigma_j**2) / tau
        # plain Black-Scholes at (r_n, sig_n): r_n replaces r everywhere,
        # the discount included (Merton 1976, Eq. 19)
        sqt = sig_n * np.sqrt(tau)
        d1 = (np.log(spot / strike) + (r_n - dividend + 0.5 * sig_n**2) * tau) / sqt
        d2 = d1 - sqt
        call = (spot * np.exp(-dividend * tau) * norm.cdf(d1)
                - strike * np.exp(-r_n * tau) * norm.cdf(d2))
        if not is_call:
            call = (call - spot * np.exp(-dividend * tau)
                    + strike * np.exp(-r_n * tau))
        total += np.exp(log_pn) * call
    return total
