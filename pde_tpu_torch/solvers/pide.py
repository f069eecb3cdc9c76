"""Jump-diffusion PIDE solver, Merton and Kou (twin of
``pde_tpu/solvers/pide.py``).

Prices European and American options under a 1D jump-diffusion

    dS/S = (r - q - lam*kbar) dt + sigma dW + (e^Y - 1) dN

where ``N`` is Poisson(lam) and the log-jump ``Y`` is lognormal (Merton
1976, :class:`MertonJumps`) or double-exponential (Kou 2002,
:class:`KouJumps`).  In log-spot ``x = ln(S/S0)`` the backward PIDE is

    V_t + 0.5 s^2 V_xx + (r - q - lam*kbar - s^2/2) V_x - (r + lam) V
        + lam * INT V(x + y) nu(y) dy = 0

* **The jump integral is one matmul.**  On the uniform log grid the
  convolution is a Toeplitz contraction with ``W[i, j] = w_j nu(x_j -
  x_i)`` (trapezoid weights); the strike strip rides the leading axis of
  ``V`` (B, n), so the non-local term of the whole strip is one
  ``(B, n) @ (n, n)`` product a pass, in full float32 on the card
  (TF32 off for the march).
* **IMEX Crank-Nicolson with fixed-point passes** (d'Halluin, Forsyth &
  Vetzal 2005): the local operator is implicit, the integral rides the CN
  right-hand side through ``fp_iterations`` passes.  Each pass is one
  batched tridiagonal solve of the strip, (B, n) with the bands shared by
  every strike: on float32 tensors on the card outside autograd ONE launch
  of K5 (:func:`~pde_tpu_torch.ops.tridiag.tridiagonal_solve`, the bands
  expanded over the strip at batch stride 0), elsewhere the factored
  Thomas solve, the matrix eliminated once.
* **Analytic tail corrections.**  Jump mass past the grid edges is
  integrated in closed form against the payoff asymptote.

Port notes: the reference's march works on (n, B) and transposes around
every solve; here the strikes lead.  :func:`kou_reference_price` is the
reference's numpy oracle, copied.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..calibrate.lm import _full_fp32_matmul
from ..core import grids
from ..core.precision import resolve_device, result_dtype, to_tensor
from ..ops.tridiag import kernel_route, thomas_factor, thomas_solve_factored, tridiagonal_solve

__all__ = ["MertonJumps", "KouJumps", "PIDEResult", "solve_pide", "kou_reference_price"]


class MertonJumps(NamedTuple):
    """Lognormal jumps: ``Y ~ N(mu_j, sigma_j^2)`` at intensity ``lam``
    (the jump leg of :class:`pde_tpu_torch.models.bates.BatesParams`).
    The methods take tensor fields; the solvers cast numbers to their
    march's dtype and device."""

    lam: torch.Tensor
    mu_j: torch.Tensor
    sigma_j: torch.Tensor

    @property
    def kbar(self):
        """E[e^Y] - 1, the martingale compensator."""
        return torch.exp(self.mu_j + 0.5 * self.sigma_j**2) - 1.0

    def density(self, y):
        """The normal density, as ``jax.scipy.stats.norm.pdf`` forms it."""
        s2 = self.sigma_j * self.sigma_j
        return torch.exp(-0.5 * (torch.log(2.0 * math.pi * s2) + (y - self.mu_j) ** 2 / s2))

    def tail_up(self, z):
        """(INT_z^inf nu,  INT_z^inf e^y nu) — upper tail mass and e^y-mass."""
        b = torch.special.ndtr((self.mu_j - z) / self.sigma_j)
        a = torch.exp(self.mu_j + 0.5 * self.sigma_j**2) * torch.special.ndtr(
            (self.mu_j + self.sigma_j**2 - z) / self.sigma_j)
        return b, a

    def tail_down(self, z):
        """(INT_-inf^z nu,  INT_-inf^z e^y nu) — lower tail counterparts."""
        b = torch.special.ndtr((z - self.mu_j) / self.sigma_j)
        a = torch.exp(self.mu_j + 0.5 * self.sigma_j**2) * torch.special.ndtr(
            (z - self.mu_j - self.sigma_j**2) / self.sigma_j)
        return b, a


class KouJumps(NamedTuple):
    """Double-exponential jumps (Kou 2002): up-jumps ``Exp(eta1)`` with
    probability ``p``, down-jumps ``-Exp(eta2)`` with probability ``1 - p``.
    Requires ``eta1 > 1`` for a finite compensator."""

    lam: torch.Tensor
    p: torch.Tensor
    eta1: torch.Tensor
    eta2: torch.Tensor

    @property
    def kbar(self):
        return (self.p * self.eta1 / (self.eta1 - 1.0)
                + (1.0 - self.p) * self.eta2 / (self.eta2 + 1.0) - 1.0)

    def density(self, y):
        up = self.p * self.eta1 * torch.exp(-self.eta1 * y)
        dn = (1.0 - self.p) * self.eta2 * torch.exp(self.eta2 * y)
        # at the y = 0 kink the mean of the one-sided limits: y = 0 is the
        # Toeplitz diagonal, and the mean keeps the trapezoid second order
        mid = 0.5 * (self.p * self.eta1 + (1.0 - self.p) * self.eta2)
        return torch.where(y > 0.0, up, torch.where(y < 0.0, dn, mid))

    def tail_up(self, z):
        # z may be negative: the upper tail then spans part of the down side
        zp = torch.clamp_min(z, 0.0)
        b_up = self.p * torch.exp(-self.eta1 * zp)
        a_up = self.p * self.eta1 / (self.eta1 - 1.0) * torch.exp(-(self.eta1 - 1.0) * zp)
        zn = torch.clamp_max(z, 0.0)
        # down-side mass in [z, 0) when z < 0
        b_dn = (1.0 - self.p) * (1.0 - torch.exp(self.eta2 * zn))
        a_dn = ((1.0 - self.p) * self.eta2 / (self.eta2 + 1.0)
                * (1.0 - torch.exp((self.eta2 + 1.0) * zn)))
        return b_up + b_dn, a_up + a_dn

    def tail_down(self, z):
        one_b, one_a = 1.0 + self.kbar, 1.0  # total e^y-mass, total mass
        b_up, a_up = self.tail_up(z)
        return one_a - b_up, one_b - a_up


class PIDEResult(NamedTuple):
    price: torch.Tensor       # (B,) per strike
    delta: torch.Tensor       # (B,)
    gamma: torch.Tensor       # (B,)
    prices: torch.Tensor      # (B, n) value grids at t=0
    spot_grid: torch.Tensor   # (n,)


def _jump_matrix(jumps, x, dx):
    """Toeplitz quadrature matrix W with (W @ V)_i ~= INT V(x_i+y) nu(y) dy:
    trapezoid weights over the grid; the mass beyond the edges is the tail
    corrections'.  The diagonal's ``x_j - x_i`` is exactly 0 (one ``x``),
    so Kou's kink takes its mean value there."""
    diff = x[None, :] - x[:, None]          # (i, j) -> x_j - x_i
    half = (0.5 * dx).reshape(1)
    w = torch.cat([half, dx.expand(x.shape[0] - 2), half])
    return jumps.density(diff) * w[None, :]


def _cast_jumps(jumps, dtype, device):
    """The jump record with every field a 0-d tensor of the march's dtype."""
    return type(jumps)(*(to_tensor(v, dtype, device) for v in jumps))


def _solve_core(jumps, sigma, r, q, T, K, S0, s_min_mult, s_max_mult, n, n_time, is_call,
                american, scheme, fp_iterations):
    """The march of a strike strip ``K`` (B,); every other input a 0-d
    tensor of K's dtype on its device, grid sizes and modes Python values."""
    f, dev = K.dtype, K.device
    B = K.shape[0]
    x = grids.linspace(torch.log(torch.tensor(s_min_mult, dtype=f, device=dev)),
                       torch.log(torch.tensor(s_max_mult, dtype=f, device=dev)), n)
    dx = (x[-1] - x[0]) / (n - 1)
    s_grid = S0 * torch.exp(x)
    dt = T / n_time
    Kc = K[:, None]

    sign = 1.0 if is_call else -1.0
    payoff = torch.clamp_min(sign * (s_grid[None, :] - Kc), 0.0)  # (B, n)

    lam, kbar = jumps.lam, jumps.kbar
    sigma2 = sigma * sigma
    drift = r - q - lam * kbar - 0.5 * sigma2
    a = 0.5 * sigma2 / (dx * dx)
    b = drift / (2.0 * dx)
    L_m = a - b
    L_c = -2.0 * a - (r + lam)
    L_p = a + b

    w = {"crank_nicolson": 0.5, "implicit": 1.0}[scheme]
    idx = torch.arange(n, device=dev)
    interior = (idx > 0) & (idx < n - 1)
    diag = torch.where(interior, 1.0 - w * dt * L_c, 1.0)
    lower = torch.where(interior[1:], -w * dt * L_m, 0.0)
    upper = torch.where(interior[:-1], -w * dt * L_p, 0.0)

    # each pass: one K5 launch on the strip on the card, the bands expanded
    # over it at batch stride 0; else the factored Thomas solve
    on_kernel = kernel_route(payoff, lower, diag, upper)
    if on_kernel:
        bands = (lower.expand(B, n - 1), diag.expand(B, n), upper.expand(B, n - 1))
    else:
        factors = thomas_factor(lower, diag, upper)

    def solve(rhs):
        if on_kernel:
            return tridiagonal_solve(*bands, rhs, use_kernel=True)
        return thomas_solve_factored(factors, rhs)

    WT = _jump_matrix(jumps, x, dx).T        # (n, n): V (B, n) @ W^T
    # tail geometry is time-independent; only the discounts move per step
    bu, au = jumps.tail_up(x[-1] - x)        # (n,)
    bd, ad = jumps.tail_down(x[0] - x)
    ex = torch.exp(x)

    def jump_term(V, df_r, df_q):
        """lam * (grid convolution + analytic edge tails).  Beyond the grid
        the value is its payoff asymptote (call: S df_q - K df_r above, 0
        below; put mirrored), integrated in closed form against nu; for
        American exercise the asymptote is the undiscounted intrinsic."""
        conv = V @ WT
        if is_call:
            tail = S0 * df_q * (ex * au)[None, :] - df_r * (bu[None, :] * Kc)
        else:
            tail = df_r * (bd[None, :] * Kc) - S0 * df_q * (ex * ad)[None, :]
        return lam * (conv + torch.clamp_min(tail, 0.0))

    def add_interior(V, extra):
        return torch.cat([V[:, :1], V[:, 1:-1] + extra[:, 1:-1], V[:, -1:]], 1)

    def explicit_rhs(V):
        LV = L_m * V[:, :-2] + L_c * V[:, 1:-1] + L_p * V[:, 2:]
        return torch.cat([V[:, :1], V[:, 1:-1] + (1.0 - w) * dt * LV, V[:, -1:]], 1)

    def apply_bc(V, df_r, df_q):
        if is_call:
            lo = torch.zeros_like(V[:, :1])
            hi = torch.clamp_min(s_grid[-1] * df_q - Kc * df_r, 0.0)
        else:
            lo = torch.clamp_min(Kc * df_r - s_grid[0] * df_q, 0.0)
            hi = torch.zeros_like(V[:, :1])
        return torch.cat([lo, V[:, 1:-1], hi], 1)

    one = torch.ones((), dtype=f, device=dev)
    V = payoff
    with _full_fp32_matmul():
        for k in range(1, n_time + 1):
            tau = dt * float(k)
            df_r, df_q = torch.exp(-r * tau), torch.exp(-q * tau)
            jdf = (one, one) if american else (df_r, df_q)
            if w == 1.0:
                base = V   # the explicit share of the local and jump terms is 0
            else:
                base = add_interior(explicit_rhs(V), (1.0 - w) * dt * jump_term(V, *jdf))
            # fixed-point passes on the CN-implicit share of the integral
            Vk = V
            for _ in range(fp_iterations):
                Vk = solve(add_interior(base, w * dt * jump_term(Vk, *jdf)))
            V = apply_bc(Vk, df_r, df_q)
            if american:
                V = torch.maximum(V, payoff)

    price = grids.interp_linear(s_grid.expand(B, n), V, S0)
    i = torch.clamp(grids.find_index(s_grid, S0), 1, n - 2)
    # the grid is uniform in x = log(S/S0): difference in log space and
    # convert (delta = V_x / S, gamma = (V_xx - V_x) / S^2); with even n
    # S0 (x = 0) lies between nodes, so the nodal derivatives are
    # Taylor-shifted to it
    at = lambda d: V[:, i + d]  # noqa: E731
    V_x_i = (at(1) - at(-1)) / (2.0 * dx)
    V_xx_i = (at(1) - 2.0 * at(0) + at(-1)) / (dx * dx)
    V_x0 = V_x_i + V_xx_i * (-x[i])
    delta = V_x0 / S0
    gamma = (V_xx_i - V_x0) / (S0 * S0)
    return PIDEResult(price, delta, gamma, V, s_grid)


def solve_pide(
    jumps,
    sigma,
    r,
    q,
    T,
    strikes,
    S0,
    is_call: bool = True,
    american: bool = False,
    n_space: int = 512,
    n_time: int = 128,
    s_min_mult: float = 0.1,
    s_max_mult: float = 10.0,
    scheme: str = "crank_nicolson",
    fp_iterations: int = 2,
    device=None,
    dtype=None,
) -> PIDEResult:
    """Price a strike strip under jump-diffusion through ONE PIDE march.

    ``jumps`` is a :class:`MertonJumps` or :class:`KouJumps`; ``strikes``
    a number or a vector: the strip shares the grid, the implicit operator
    and the jump matmul.  Runs on ``device`` (default: the CUDA card) in
    ``dtype`` (default: the dtype of the tensors among sigma, r, T,
    strikes and S0, else torch's default float); the jump parameters are
    cast to it.
    """
    if not isinstance(jumps, (MertonJumps, KouJumps)):
        raise TypeError(f"unsupported jump family {type(jumps).__name__}")
    if scheme not in ("crank_nicolson", "implicit"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if n_space < 16 or n_time < 10:
        raise ValueError("n_space >= 16 and n_time >= 10 required")
    if fp_iterations < 1:
        raise ValueError("fp_iterations must be >= 1")
    device = resolve_device(device)
    f = dtype or result_dtype(sigma, r, T, strikes, S0)
    K = torch.atleast_1d(to_tensor(strikes, f, device)).reshape(-1)
    sigma, r, q, T, S0 = (to_tensor(a, f, device) for a in (sigma, r, q, T, S0))
    return _solve_core(_cast_jumps(jumps, f, device), sigma, r, q, T, K, S0, s_min_mult,
                       s_max_mult, int(n_space), int(n_time), bool(is_call), bool(american),
                       scheme, int(fp_iterations))


def kou_reference_price(
    strike, maturity, spot, rate, dividend, bs_vol, lam, p, eta1, eta2,
    is_call=True, u_max=400.0, n_u=120_000,
):
    """Kou (2002) European price via float64 Gil-Pelaez quadrature: an
    independent numpy oracle for the Kou PIDE path (no solver code
    shared).  Midpoint rule on ``u in (0, u_max]``; the CF decays like
    ``exp(-0.5 sigma^2 T u^2)``, so the truncation is far below 1e-10 for
    any sigma*sqrt(T) >= 0.05.
    """
    strike = np.asarray(strike, dtype=np.float64)
    tau, x0 = float(maturity), np.log(float(spot))
    kbar = p * eta1 / (eta1 - 1.0) + (1.0 - p) * eta2 / (eta2 + 1.0) - 1.0
    omega = rate - dividend - 0.5 * bs_vol**2 - lam * kbar

    def cf(u):
        u = np.asarray(u, dtype=np.complex128)
        jhat = p * eta1 / (eta1 - 1j * u) + (1.0 - p) * eta2 / (eta2 + 1j * u)
        return np.exp(
            1j * u * (x0 + omega * tau)
            - 0.5 * bs_vol**2 * u**2 * tau
            + lam * tau * (jhat - 1.0)
        )

    du = u_max / n_u
    u = (np.arange(n_u) + 0.5) * du
    k = np.log(strike)[:, None]
    phi = cf(u)[None, :]
    phi_s = cf(u - 1j)[None, :] / cf(-1j)  # measure-changed CF for P1
    p2 = 0.5 + du / np.pi * np.sum((np.exp(-1j * u * k) * phi / (1j * u)).real, axis=1)
    p1 = 0.5 + du / np.pi * np.sum((np.exp(-1j * u * k) * phi_s / (1j * u)).real, axis=1)
    call = spot * np.exp(-dividend * tau) * p1 - strike * np.exp(-rate * tau) * p2
    if is_call:
        return call
    return call - spot * np.exp(-dividend * tau) + strike * np.exp(-rate * tau)
