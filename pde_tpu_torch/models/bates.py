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

Monte Carlo reuses the Andersen QE step of
:mod:`pde_tpu_torch.models.heston_mc` with a per-step compound-Poisson
overlay, so the exotic payoff estimators price under jumps too.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.precision import device_of, result_dtype, to_tensor
from . import heston as heston_model
from . import heston_mc
from .heston import HestonParams, _host
from .heston_mc import MCPaths, _make_qe_step

__all__ = [
    "BatesParams",
    "price_carr_madan_gl",
    "price_carr_madan_gl_grouped",
    "price_accurate",
    "price_accurate_grouped",
    "price_fft",
    "implied_volatility",
    "implied_volatility_grouped",
    "simulate_qe",
    "price_european_mc",
    "price_path_payoff_mc",
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


# -- Monte Carlo: QE diffusion + per-step compound-Poisson jump overlay ------

def _jump_step(params: BatesParams, spot, maturity, generator, rate, dividend, n_steps,
               n_paths, antithetic, martingale_correction, device):
    """The step ``(ln_s, v, k_t) -> (ln_s', v')`` of a Bates simulation (QE
    diffusion with the ``-lam kbar dt`` compensator, then the step's jumps),
    the ``n_steps`` step sources of ``generator``, and the start state
    ``(s0, ln_s0, v0)``."""
    dtype = result_dtype(spot, maturity, params.kappa)
    device = device_of(spot, maturity, *params, default=device)
    xs = heston_mc._draws(generator, device).split(n_steps)
    lam, mu_j, sigma_j = (to_tensor(x, dtype, device)
                          for x in (params.lam, params.mu_j, params.sigma_j))
    kbar = torch.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0
    _, _, dt, consts, theta, drift, s0, ln_s0, v0 = heston_mc._setup(
        params, spot, maturity, rate, dividend, n_steps, n_paths, antithetic, device,
        extra_drift=lam * kbar)
    E, c1, c2, k0_plain, k1, k2, k3, k4 = consts
    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_paths // 2 if antithetic else n_paths, antithetic, martingale_correction, dtype,
    )

    def step(ln_s, v, k_t):
        k_diff, k_n, k_j = k_t.split(3)
        ln_s_new, v_new = qe_step(ln_s, v, k_diff)
        n_jumps = k_n.poisson(lam * dt, (n_paths,))
        z_j = k_j.normal((n_paths,), dtype, device)
        return ln_s_new + n_jumps * mu_j + torch.sqrt(n_jumps) * sigma_j * z_j, v_new

    return step, xs, s0, ln_s0, v0


def simulate_qe(
    params: BatesParams,
    spot,
    maturity,
    generator,
    *,
    n_steps: int = 64,
    n_paths: int = 65536,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    martingale_correction: bool = True,
    device=None,
) -> MCPaths:
    """Simulate Bates paths: Andersen QE for (ln S, v) plus jumps.

    Per step the log-price gains ``sum_{k<=N_t} J_k`` with ``N_t ~
    Poisson(lam dt)``, drawn as ``N_t mu_j + sqrt(N_t) sigma_j Z`` (exact:
    a sum of ``N_t`` i.i.d. normals), while the diffusion drift carries the
    ``-lam kbar dt`` compensator.  The jumps land inside the step loop, so
    the running average/max/min see them.  Antithetic mirroring applies to
    the diffusion draws only.  ``generator`` is a ``torch.Generator`` on the
    path's device or a replay (:mod:`pde_tpu_torch.models.heston_mc`).
    """
    step, xs, s0, ln_s0, v0 = _jump_step(params, spot, maturity, generator, rate, dividend,
                                         n_steps, n_paths, antithetic, martingale_correction,
                                         device)
    return heston_mc._simulate_stats(step, xs, s0, ln_s0, v0, n_steps)


def simulate_qe_paths(
    params: BatesParams,
    spot,
    maturity,
    generator,
    *,
    n_steps: int = 64,
    n_paths: int = 65536,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    martingale_correction: bool = True,
    device=None,
):
    """Stored-path Bates simulation: ``(S, v)`` of shape ``(n_steps,
    n_paths)`` at t_1..t_N, the jump-overlay twin of
    :func:`heston_mc.simulate_qe_paths`; American exercise under jumps via
    :func:`pde_tpu_torch.solvers.lsm.price_american_lsm` with
    ``simulate_paths_fn=`` this."""
    step, xs, _, ln_s0, v0 = _jump_step(params, spot, maturity, generator, rate, dividend,
                                        n_steps, n_paths, antithetic, martingale_correction,
                                        device)
    return heston_mc._simulate_stored(step, xs, ln_s0, v0)


def price_american_mc(params: BatesParams, strike, maturity, spot, generator, **kwargs):
    """American vanilla under Bates via Longstaff-Schwartz on the
    jump-overlay paths.  Returns ``(price, stderr)``."""
    from ..solvers import lsm

    return lsm.price_american_lsm(params, strike, maturity, spot, generator,
                                  simulate_paths_fn=simulate_qe_paths, **kwargs)


def price_path_payoff_mc(params: BatesParams, payoff_fn, spot, maturity, generator, **kwargs):
    """Bates path-payoff pricing: heston_mc's estimator machinery (control
    variate, antithetic pair-folding) over :func:`simulate_qe`."""
    return heston_mc.price_path_payoff_mc(params, payoff_fn, spot, maturity, generator,
                                          simulate_fn=simulate_qe, **kwargs)


def price_european_mc(params: BatesParams, strikes, maturity, spot, generator, **kwargs):
    """European vanilla under Bates via QE + jump overlay MC.  Returns
    (price, stderr) shaped like ``strikes``."""
    return heston_mc.price_european_mc(params, strikes, maturity, spot, generator,
                                       simulate_fn=simulate_qe, **kwargs)


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
