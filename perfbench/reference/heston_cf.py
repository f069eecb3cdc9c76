"""Plain reference of the Fourier-priced book: Heston European prices by
the damped Carr-Madan integral in forward moneyness, on the configuration's
quadrature.

The rule reproduces the reference C++ grid's rectangle sum (heston.cpp:
104-137: j = 1 .. N-1 at spacing du, no end weights) from ``n_points``
Gauss-Legendre nodes on [0, N du] plus six nodes for the Euler-Maclaurin
end corrections (one-sided three-point stencils at spacing h).  The call
is K (F/K)^(alpha+1) e^{-rT} / pi times the sum, floored at 0; the put
comes from parity, floored at 0.

``rounding`` names the precision every operation is rounded to: none (the
reference, in complex128) or ``"bfloat16"`` (its control: complex64
arithmetic with each result's real and imaginary parts rounded to
bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rule(n_points: int, du: float, u_max: float, h: float = 0.005):
    """Nodes and weights (float64 numpy) whose weighted sum of f is the
    rectangle sum du * sum_{j=1}^{J-1} f(j du), J du = u_max."""
    x, wx = np.polynomial.legendre.leggauss(n_points)
    v = 0.5 * u_max * (x + 1.0)
    w = 0.5 * u_max * wx
    c = du * du / 12.0
    ends = np.array([0.0, h, 2.0 * h, u_max - 2.0 * h, u_max - h, u_max])
    w_ends = np.concatenate([np.array([3.0, -4.0, 1.0]) * (c / (2.0 * h)),
                             np.array([1.0, -4.0, 3.0]) * (c / (2.0 * h))])
    w_ends[0] -= du / 2.0
    w_ends[-1] -= du / 2.0
    return np.concatenate([v, ends]), np.concatenate([w, w_ends])


def _rounder(rounding):
    if rounding is None:
        return (lambda z: z), torch.float64, torch.complex128

    def rnd(z):
        if z.is_complex():
            return torch.complex(z.real.to(torch.bfloat16).float(),
                                 z.imag.to(torch.bfloat16).float())
        return z.to(torch.bfloat16).float()

    return rnd, torch.float32, torch.complex64


def prices(book: dict, r: float, q: float, quad: dict, rounding=None,
           block: int = 1 << 18) -> torch.Tensor:
    """Prices (N,) float64 of the book (kappa, theta, sigma, rho, v0, S0,
    K, T, is_call, each (N,)), ``block`` rows at a time."""
    out = [_prices_block({k: t[i:i + block] for k, t in book.items()}, r, q, quad, rounding)
           for i in range(0, book["K"].shape[0], block)]
    return torch.cat(out)


def _prices_block(book, r, q, quad, rounding):
    rnd, f, c = _rounder(rounding)
    dev = book["K"].device
    v_np, w_np = rule(quad["n_points"], quad["du"], quad["n_quadrature"] * quad["du"])
    v = rnd(torch.as_tensor(v_np, dtype=f, device=dev))
    w = rnd(torch.as_tensor(w_np, dtype=f, device=dev))
    alpha = quad["alpha"]
    col = lambda k: rnd(book[k].to(f))[:, None]                 # noqa: E731  (N, 1)
    kappa, theta, sigma, rho, v0 = (col(k) for k in ("kappa", "theta", "sigma", "rho", "v0"))
    S0, K, T = (rnd(book[k].to(f)) for k in ("S0", "K", "T"))
    Tc = T[:, None]

    u = rnd(v.to(c) - 1j * (alpha + 1.0))                        # (M,)
    s2 = rnd(sigma * sigma)
    xi = rnd(kappa - rnd(rnd(rho * sigma) * rnd(1j * u)))
    d = rnd(torch.sqrt(rnd(rnd(xi * xi) + rnd(s2 * rnd(rnd(1j * u) + rnd(u * u))))))
    g = rnd(rnd(xi - d) / rnd(xi + d))
    e = rnd(torch.exp(rnd(-d * Tc)))
    ge = rnd(1.0 - rnd(g * e))
    C = rnd(rnd(rnd(kappa * theta) / s2) * rnd(rnd(rnd(xi - d) * Tc)
                                              - rnd(2.0 * rnd(torch.log(rnd(ge / rnd(1.0 - g)))))))
    D = rnd(rnd(rnd(xi - d) / s2) * rnd(rnd(1.0 - e) / ge))
    cf = rnd(torch.exp(rnd(C + rnd(D * v0))))
    fwd = rnd(S0 * rnd(torch.exp(rnd((r - q) * T))))
    log_fk = rnd(torch.log(rnd(fwd / K)))[:, None]
    phase = rnd(torch.exp(rnd(1j * rnd(v.to(c) * log_fk))))
    den = rnd(torch.complex(rnd(alpha * alpha + alpha - rnd(v * v)), rnd((2.0 * alpha + 1.0) * v)))
    integrand = rnd(rnd(rnd(cf * phase) / den).real)
    integral = rnd(torch.sum(rnd(w * integrand), dim=-1))
    disc = rnd(torch.exp(rnd(-r * T)))
    pre = rnd(K * rnd(rnd(fwd / K) ** (alpha + 1.0)))
    call = torch.clamp_min(rnd(rnd(rnd(pre / math.pi) * disc) * integral), 0.0)
    put = torch.clamp_min(rnd(rnd(call - rnd(S0 * rnd(torch.exp(rnd(-q * T))))) + rnd(K * disc)), 0.0)
    return torch.where(book["is_call"] > 0.5, call, put).to(torch.float64)
