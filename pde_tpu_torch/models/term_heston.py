"""Term-structure Heston: piecewise-constant parameters by Riccati gluing
(twin of ``pde_tpu/models/term_heston.py``).

(kappa, theta, sigma, rho) are piecewise constant in time (Mikhailov &
Noegel 2003); solving backward from maturity, the ``D`` exponent at the
start of interval ``j`` is the terminal condition of interval ``j-1``, for
which the constant-parameter Riccati still has a closed form.

:class:`TermHestonParams`' ``cf_reduced_extra`` hook divides out the base
constant-parameter exponents and multiplies the glued ones in, so every
pricer of :mod:`pde_tpu_torch.models.heston` prices the term-structure
model.  The interval loop is a Python loop over the M intervals (M is the
contract schedule, not data).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.precision import device_of, result_dtype, to_tensor
from . import heston
from .heston import HestonParams, _host

__all__ = ["TermHestonParams", "make_term_params", "price_term_heston"]


def _riccati_step(u, D0, C0, kappa, th, sig, rho_, tau, i):
    """Advance the Heston log-CF exponents (C, D) by ``tau`` under constant
    parameters from terminal values (C0, D0), Mikhailov-Noegel closed form.
    ``tau = 0`` returns (C0, D0) exactly."""
    sigma2 = sig * sig
    xi = kappa - rho_ * sig * i * u
    d = torch.sqrt(xi * xi + sigma2 * (i * u + u * u))
    # generalized g with a non-zero terminal condition D0 (g-tilde)
    gt = (xi - d - sigma2 * D0) / (xi + d - sigma2 * D0)
    e = torch.exp(-d * tau)
    one_mgte = 1.0 - gt * e
    C = C0 + (kappa * th / sigma2) * (
        (xi - d) * tau - 2.0 * torch.log(one_mgte / (1.0 - gt)))
    D = (xi - d - (xi + d) * gt * e) / (sigma2 * one_mgte)
    return C, D


class TermHestonParams(NamedTuple):
    """Piecewise-constant Heston parameters.

    ``edges`` are the M+1 increasing interval boundaries starting at 0.0;
    ``kappas..rhos`` the per-interval values (shape (M,)).  The scalar
    ``kappa..rho`` base fields (which ``heston._cf_reduced`` uses, and the
    hook divides back out) are the first interval's values; ``v0`` is the
    time-0 variance.  Build with :func:`make_term_params`.
    """

    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    rho: torch.Tensor
    v0: torch.Tensor
    edges: torch.Tensor
    kappas: torch.Tensor
    thetas: torch.Tensor
    sigmas: torch.Tensor
    rhos: torch.Tensor

    def cf_reduced_extra(self, u, T, rdt, cdt):
        """exp(C_glued + D_glued v0 - C_base - D_base v0).  At ``u = -i``
        every interval's Riccati solution is 0, so the factor is 1."""
        def f(x):
            return to_tensor(x, rdt, u.device)

        v0 = f(self.v0)
        edges, kappas, thetas, sigmas, rhos = (
            f(x) for x in (self.edges, self.kappas, self.thetas, self.sigmas, self.rhos))
        zero = torch.zeros_like(u)

        # glued exponents: backward over the interval list
        C = D = zero
        for j in reversed(range(kappas.shape[0])):
            tau_j = torch.minimum(edges[j + 1], T) - torch.minimum(edges[j], T)
            C, D = _riccati_step(u, D, C, kappas[j], thetas[j], sigmas[j], rhos[j],
                                 tau_j, 1j)

        # base exponents over the full [0, T] with the scalar fields
        C_b, D_b = _riccati_step(u, zero, zero, f(self.kappa), f(self.theta),
                                 f(self.sigma), f(self.rho), T, 1j)
        return torch.exp((C - C_b) + (D - D_b) * v0)

    def interval_params(self, j: int) -> HestonParams:
        return HestonParams(self.kappas[j], self.thetas[j], self.sigmas[j],
                            self.rhos[j], self.v0)


def make_term_params(
    edges: Sequence[float],
    kappas, thetas, sigmas, rhos,
    v0,
    *,
    device=None,
    dtype=None,
) -> TermHestonParams:
    """Build :class:`TermHestonParams` from interval edges and per-interval
    values.  ``edges`` must start at 0 and be strictly increasing, with one
    more entry than the parameter lists.  The fields are tensors on the
    device of the first tensor given, else on ``device`` (default: the CUDA
    card), of ``dtype`` (default: the tensors' type, at least torch's
    default float)."""
    e = np.asarray(edges, dtype=float)
    if e[0] != 0.0 or np.any(np.diff(e) <= 0):
        raise ValueError("edges must start at 0 and be strictly increasing")
    m = len(e) - 1
    for name, arr in (("kappas", kappas), ("thetas", thetas),
                      ("sigmas", sigmas), ("rhos", rhos)):
        if len(arr) != m:
            raise ValueError(f"{name} must have {m} entries, got {len(arr)}")
    device = device_of(kappas, thetas, sigmas, rhos, v0, default=device)
    dtype = dtype or result_dtype(kappas, thetas, sigmas, rhos, v0)
    ka, th, si, rh = (to_tensor(x, dtype, device) for x in (kappas, thetas, sigmas, rhos))
    return TermHestonParams(ka[0], th[0], si[0], rh[0], to_tensor(v0, dtype, device),
                            to_tensor(e, dtype, device), ka, th, si, rh)


def price_term_heston(
    params: TermHestonParams,
    strikes,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
):
    """Vanillas under the piecewise-constant model through the converged
    Carr-Madan pricer (``heston.price_accurate``): any maturity up to the
    last edge (the last interval's parameters extend to T only if
    ``edges[-1] >= T``; pad the edges generously)."""
    if np.any(_host(params.edges)[-1] < _host(maturity) - 1e-12):
        raise ValueError("maturity extends past edges[-1]; extend the last interval")
    return heston.price_accurate(params, strikes, maturity, spot, rate, dividend, is_call)
