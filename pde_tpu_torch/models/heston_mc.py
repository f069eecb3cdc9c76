"""Heston Monte Carlo engine: Andersen (2008) Quadratic-Exponential scheme
(twin of ``pde_tpu/models/heston_mc.py``).

An independent, simulation-based pricing path for the model the
characteristic-function pricer (:mod:`pde_tpu_torch.models.heston`) and the
ADI solver (:mod:`pde_tpu_torch.solvers.heston_adi`) price, and the one
that reaches path-dependent payoffs: discretely monitored barriers,
arithmetic Asians, lookbacks, forward starts and cliquets.

The path axis is the vector axis: a ``(n_paths,)`` state carried through a
loop of whole-tensor steps, one per time step, with the running average,
maximum and minimum as O(1)-memory accumulators.  Antithetic variates are a
``cat([z, -z])`` on that axis; the martingale control variate (the
discounted terminal spot) removes most of the residual bias on Europeans.

Scheme (Andersen 2008, QE with martingale correction):

* variance: moment-matched quadratic (``psi <= psi_c``) or
  exponential-mass-at-zero (``psi > psi_c``) sampling of the exact CIR
  transition's first two moments;
* log-spot: central discretization (gamma1 = gamma2 = 1/2) with the
  per-path drift ``K0*`` that makes the discounted spot an exact discrete
  martingale (section 4.2, eqs. 37-40).

Both branches are evaluated and selected with ``torch.where``: no
data-dependent control flow.

**Draws.**  Where the reference takes a PRNG key, each simulator and
pricer takes a ``torch.Generator``, which must live on the path's device
(``ValueError`` otherwise), or a replay (:class:`_Replay`).  Every draw of
a simulation goes through one source, split as the reference splits its
key (``n_steps`` children, then ``(u, z)`` per step; ``(lms, shift)`` for
Sobol; one child per Sobol replicate), so a source that answers each split
and draw with the reference's own draws reproduces it to roundoff.  A
generator's splits all hand on the one stream.  Entry points run on their
inputs' device (the first tensor's among spot, maturity and the
parameters), else on ``device``, else on the card.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import qmc
from ..core.precision import check_generator, device_of, result_dtype, to_tensor
from .heston import HestonParams

__all__ = [
    "MCPaths",
    "simulate_qe",
    "simulate_qe_paths",
    "price_european_mc",
    "price_asian_mc",
    "price_barrier_mc",
    "price_lookback_mc",
    "price_path_payoff_mc",
    "price_forward_start_mc",
    "price_cliquet_mc",
    "greeks_european_mc",
]

PSI_CRIT = 1.5  # Andersen's psi_c switching threshold (section 3.2.4)
_TINY = 1e-12


class MCPaths(NamedTuple):
    """Terminal state and path statistics of one QE simulation.

    All fields are ``(n_paths,)`` tensors.  ``s_avg`` is the arithmetic
    average of the spot over the ``n_steps`` monitoring dates (t_1 .. t_N =
    T, excluding t_0); ``s_max``/``s_min`` include the initial spot.
    """

    spot: torch.Tensor
    variance: torch.Tensor
    s_avg: torch.Tensor
    s_max: torch.Tensor
    s_min: torch.Tensor
    # Brownian-bridge survival probability w.r.t. a continuous barrier
    # (only when simulate_qe is given a ``barrier``; None otherwise)
    survival: torch.Tensor | None = None


# -- draw sources ------------------------------------------------------------

class _GeneratorDraws:
    """The draws of one ``torch.Generator``, in the order they are asked
    for: a stream needs no key tree, so every split hands it on."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def split(self, n: int):
        return [self] * n

    def uniform(self, shape, dtype, device):
        return torch.rand(shape, generator=self.generator, dtype=dtype, device=device)

    def normal(self, shape, dtype, device):
        return torch.randn(shape, generator=self.generator, dtype=dtype, device=device)

    def bits(self, shape, device):
        return qmc._words(self.generator, shape, device)

    def poisson(self, rate: torch.Tensor, shape):
        return torch.poisson(rate.expand(shape).contiguous(), generator=self.generator)

    def gamma(self, alpha: torch.Tensor):
        return torch._standard_gamma(alpha, generator=self.generator)

    # ``count`` asks for ``count`` draws, one from each of ``split(count)``
    # (a key's source ``vmap``s them): for a stream, one batched draw

    def randint(self, low: int, high: int, shape, device, count=None):
        shape = tuple(shape) if count is None else (count, *shape)
        return torch.randint(low, high, shape, generator=self.generator, device=device)

    def permutation(self, n: int, device, count=None):
        """A uniform permutation of range(n) (``count`` of them as rows),
        as the order that sorts uniform float64 draws."""
        shape = (n,) if count is None else (count, n)
        u = torch.rand(shape, generator=self.generator, dtype=torch.float64, device=device)
        return torch.argsort(u, dim=-1)

    def student_t(self, df: float, shape, dtype, device):
        """Student-t with ``df`` degrees of freedom: z / sqrt(chi2 / df), the
        chi-square as 2 Gamma(df / 2)."""
        z = torch.randn(shape, generator=self.generator, dtype=dtype, device=device)
        half = torch.full(shape, 0.5 * df, dtype=dtype, device=device)
        g = torch._standard_gamma(half, generator=self.generator)
        return z / torch.sqrt(2.0 * g / df)


class _Replay:
    """A draw source that makes each draw once, from ``source``, and hands
    the same draw back whenever it is asked again, as a PRNG key does; its
    splits are replays too.  So a simulation run twice on one replay sees
    the same draws, and a run in another dtype or on another device sees
    them moved there (float64 draws replayed in float32 on the card)."""

    def __init__(self, source):
        self._source, self._children, self._drawn = source, None, None

    def split(self, n: int):
        if self._children is None:
            self._children = [_Replay(s) for s in self._source.split(n)]
        if len(self._children) != n:
            raise ValueError(f"this replay was split {len(self._children)} ways, not {n}")
        return self._children

    def _once(self, kind, shape, draw):
        if self._drawn is None:
            self._drawn = (kind, tuple(shape), draw())
        was, was_shape, value = self._drawn
        if (was, was_shape) != (kind, tuple(shape)):
            raise ValueError(f"this replay drew {was}{was_shape}, not {kind}{tuple(shape)}")
        return value

    def uniform(self, shape, dtype, device):
        return self._once("uniform", shape, lambda: self._source.uniform(
            shape, dtype, device)).to(dtype=dtype, device=device)

    def normal(self, shape, dtype, device):
        return self._once("normal", shape, lambda: self._source.normal(
            shape, dtype, device)).to(dtype=dtype, device=device)

    def bits(self, shape, device):
        return self._once("bits", shape, lambda: self._source.bits(shape, device)).to(device)

    def poisson(self, rate, shape):
        return self._once("poisson", shape, lambda: self._source.poisson(rate, shape)).to(
            dtype=rate.dtype, device=rate.device)

    def gamma(self, alpha):
        return self._once("gamma", alpha.shape, lambda: self._source.gamma(alpha)).to(
            dtype=alpha.dtype, device=alpha.device)

    def randint(self, low, high, shape, device, count=None):
        full = tuple(shape) if count is None else (count, *shape)
        return self._once(f"randint[{low}, {high})", full, lambda: self._source.randint(
            low, high, shape, device, count)).to(device)

    def permutation(self, n, device, count=None):
        full = (n,) if count is None else (count, n)
        return self._once("permutation", full, lambda: self._source.permutation(
            n, device, count)).to(device)

    def student_t(self, df, shape, dtype, device):
        return self._once(f"student_t({df})", shape, lambda: self._source.student_t(
            df, shape, dtype, device)).to(dtype=dtype, device=device)


def _draws(generator, device):
    """The draw source of a simulation on ``device``: a ``torch.Generator``
    (which must live there) or a replay, handed on as it is."""
    if isinstance(generator, torch.Generator):
        check_generator(generator, device)
        return _GeneratorDraws(generator)
    return generator


def _ndim(x) -> int:
    return x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)


def _sign(is_call, shape, dtype, device):
    """+1 for calls, -1 for puts, broadcast to ``shape``."""
    flag = torch.as_tensor(is_call, device=device)
    return torch.where(flag, 1.0, -1.0).to(dtype).expand(shape)


# -- the QE scheme -----------------------------------------------------------

def _qe_constants(params: HestonParams, dt: torch.Tensor, dtype):
    """Per-step constants of the QE scheme (independent of the state), on
    ``dt``'s device."""
    kappa, theta, sigma, rho = (to_tensor(getattr(params, f), dtype, dt.device)
                                for f in ("kappa", "theta", "sigma", "rho"))

    E = torch.exp(-kappa * dt)  # exp(-kappa*Delta)
    one_mE = 1.0 - E
    sig2 = sigma * sigma
    # CIR conditional-moment coefficients:  m = theta + (v - theta) E,
    # s^2 = c1 * v + c2   (Andersen eqs. 17-18)
    c1 = sig2 * E * one_mE / kappa
    c2 = theta * sig2 * one_mE * one_mE / (2.0 * kappa)

    gamma1 = gamma2 = 0.5  # central discretization
    k1 = gamma1 * dt * (kappa * rho / sigma - 0.5) - rho / sigma
    k2 = gamma2 * dt * (kappa * rho / sigma - 0.5) + rho / sigma
    k3 = gamma1 * dt * (1.0 - rho * rho)
    k4 = gamma2 * dt * (1.0 - rho * rho)
    # non-martingale drift constant (used when martingale correction is off)
    k0 = -rho * kappa * theta * dt / sigma
    return E, c1, c2, k0, k1, k2, k3, k4


def _qe_variance_draw(v, u, E, c1, c2, theta, psi_c, dtype):
    """One QE variance transition v_t -> v_{t+dt} given a uniform draw.

    Returns (v_new, a, b2, p, beta, is_quad): the branch intermediates are
    needed again by the martingale K0* correction.
    """
    m = theta + (v - theta) * E
    m = torch.clamp_min(m, _TINY)
    s2 = c1 * v + c2
    psi = s2 / (m * m)

    # quadratic branch (psi <= psi_c):  v+ = a (b + Z)^2
    inv_psi2 = 2.0 / torch.clamp_min(psi, _TINY)
    b2 = torch.clamp_min(
        inv_psi2 - 1.0 + torch.sqrt(torch.clamp_min(inv_psi2 * (inv_psi2 - 1.0), 0.0)), 0.0)
    a = m / (1.0 + b2)
    eps = torch.finfo(dtype).eps
    u_c = torch.clamp(u, eps, 1.0 - eps)
    z_v = torch.special.ndtri(u_c)
    v_quad = a * (torch.sqrt(b2) + z_v) ** 2

    # exponential branch (psi > psi_c): mass p at zero + exponential tail
    p = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, 1.0 - 1e-6)
    beta = (1.0 - p) / m
    v_exp = torch.where(u_c <= p, 0.0,
                        torch.log((1.0 - p) / torch.clamp_min(1.0 - u_c, _TINY)) / beta)

    is_quad = psi <= psi_c
    v_new = torch.where(is_quad, v_quad, v_exp)
    return v_new, a, b2, p, beta, is_quad


def _qe_k0_star(v, a, b2, p, beta, is_quad, k1, k2, k3, k4):
    """Martingale-corrected drift constant K0* (Andersen eqs. 37-40), chosen
    so that E[exp(K0* + K1 v + K2 v' + sqrt(K3 v + K4 v') Z)] = 1 exactly
    under the discrete scheme."""
    A = k2 + 0.5 * k4
    # quadratic branch:  -A b^2 a / (1 - 2 A a) + 0.5 log(1 - 2 A a)
    one_m2Aa = torch.clamp_min(1.0 - 2.0 * A * a, _TINY)
    k0_quad = -A * b2 * a / one_m2Aa + 0.5 * torch.log(one_m2Aa)
    # exponential branch: -log(p + beta (1 - p) / (beta - A))
    beta_mA = torch.clamp_min(beta - A, _TINY)
    k0_exp = -torch.log(torch.clamp_min(p + beta * (1.0 - p) / beta_mA, _TINY))
    k0 = torch.where(is_quad, k0_quad, k0_exp)
    return k0 - (k1 + 0.5 * k3) * v


def _sampler_scan_inputs(sampler, source, n_steps, antithetic, device):
    """Per-step inputs for a sampler: the draw source's ``n_steps`` children
    (pseudo), or scrambled Sobol direction-number slices and digital shifts
    (sobol; Matousek LMS + shift from the source's two children, dims (2t,
    2t+1) feeding step t)."""
    if sampler == "sobol":
        if antithetic:
            raise ValueError(
                "sampler='sobol' already stratifies; antithetic sampling "
                "does not compose with it — pass antithetic=False"
            )
        dim = 2 * n_steps
        s_lms, s_shift = source.split(2)
        dv_s = qmc._scramble_direction_numbers(qmc.sobol_direction_numbers(dim),
                                               s_lms.bits((dim, qmc._NBITS), device))
        shifts = s_shift.bits((dim,), device)
        return list(zip(dv_s.reshape(n_steps, 2, -1), shifts.reshape(n_steps, 2)))
    if sampler != "pseudo":
        raise ValueError(f"unknown sampler {sampler!r}")
    return source.split(n_steps)


def _make_qe_step(
    E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
    n_draw, antithetic, martingale_correction, dtype,
    sampler="pseudo", n_paths=None,
):
    """One QE transition (ln_s, v, x_t) -> (ln_s', v'), shared by the
    accumulator simulation (:func:`simulate_qe`) and the stored-path one
    (:func:`simulate_qe_paths`).

    ``x_t`` is the step's input: a draw source under the pseudo-random
    sampler, or a ``(dv_slice (2, 32), shift (2,))`` pair of scrambled
    Sobol direction numbers and digital shift under ``sampler="sobol"``
    (one QMC dimension pair per time step; the path index is the point
    index).
    """
    device = E.device
    if sampler == "sobol":
        g = qmc.gray_codes(n_paths, device=device)  # hoisted: point index == path index

    def qe_step(ln_s, v, x_t):
        if sampler == "sobol":
            dv_t, shift_t = x_t
            x = qmc.sobol_uint32_from_gray(g, dv_t, shift_t)
            u = qmc.to_unit(x[:, 0], dtype)
            z_s = torch.special.ndtri(qmc.to_unit(x[:, 1], dtype))
        else:
            s_u, s_z = x_t.split(2)
            u = s_u.uniform((n_draw,), dtype, device)
            z_s = s_z.normal((n_draw,), dtype, device)
            if antithetic:
                u = torch.cat([u, 1.0 - u])
                z_s = torch.cat([z_s, -z_s])

        v_new, a, b2, p, beta, is_quad = _qe_variance_draw(
            v, u, E, c1, c2, theta, PSI_CRIT, dtype)
        if martingale_correction:
            k0 = _qe_k0_star(v, a, b2, p, beta, is_quad, k1, k2, k3, k4)
        else:
            k0 = k0_plain
        # Safe sqrt: on Feller-violating paths the variance is absorbed at
        # exactly 0 and sqrt'(0) = inf would turn every parameter tangent
        # into NaN under forward AD (greeks_european_mc).  The double where
        # keeps the primal and gives the a.e.-correct 0 tangent there.
        var_s = k3 * v + k4 * v_new
        pos = var_s > 0.0
        vol = torch.where(pos, torch.sqrt(torch.where(pos, var_s, 1.0)), 0.0)
        ln_s_new = ln_s + drift + k0 + k1 * v + k2 * v_new + vol * z_s
        return ln_s_new, v_new

    return qe_step


def _setup(params, spot, maturity, rate, dividend, n_steps, n_paths, antithetic, device,
           extra_drift=0.0):
    """dtype, device, dt, QE constants, theta, drift, the initial spot, and
    log-spot and variance ``(n_paths,)`` of a simulation (the reference's
    preamble).  ``extra_drift`` (a jump compensator) is subtracted from
    ``rate - dividend``."""
    dtype = result_dtype(spot, maturity, params.kappa)
    device = device_of(spot, maturity, *params, default=device)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    dt = to_tensor(maturity, dtype, device) / n_steps
    consts = _qe_constants(params, dt, dtype)
    theta = to_tensor(params.theta, dtype, device)
    drift = (to_tensor(rate, dtype, device) - to_tensor(dividend, dtype, device)
             - extra_drift) * dt
    s0 = to_tensor(spot, dtype, device)
    ln_s0 = torch.log(s0).expand(n_paths)
    v0 = to_tensor(params.v0, dtype, device).expand(n_paths)
    return dtype, device, dt, consts, theta, drift, s0, ln_s0, v0


def _simulate_stats(transition, xs, s0, ln_s0, v0, n_steps, survival=None):
    """Run ``transition(ln_s, v, x_t) -> (ln_s', v')`` over ``xs`` with the
    running sum, max and min of the spot (and, with ``survival(ln_s, v,
    ln_s', v')``, the product of the steps' survival probabilities)."""
    n_paths = ln_s0.shape[-1]
    ln_s, v = ln_s0, v0
    s_sum = torch.zeros_like(ln_s0)
    s_max = s_min = s0.expand(n_paths)
    surv = torch.ones_like(ln_s0) if survival is not None else None
    for x_t in xs:
        ln_s_new, v_new = transition(ln_s, v, x_t)
        s = torch.exp(ln_s_new)
        if survival is not None:
            surv = surv * survival(ln_s, v, ln_s_new, v_new)
        ln_s, v = ln_s_new, v_new
        s_sum = s_sum + s
        s_max = torch.maximum(s_max, s)
        s_min = torch.minimum(s_min, s)
    return MCPaths(torch.exp(ln_s), v, s_sum / n_steps, s_max, s_min, surv)


def _simulate_stored(transition, xs, ln_s0, v0):
    """Run ``transition`` over ``xs``, keeping every step: ``(S, v)`` of
    shape ``(n_steps, n_paths)``."""
    ln_s, v = ln_s0, v0
    ln_s_path, v_path = [], []
    for x_t in xs:
        ln_s, v = transition(ln_s, v, x_t)
        ln_s_path.append(ln_s)
        v_path.append(v)
    return torch.exp(torch.stack(ln_s_path)), torch.stack(v_path)


def simulate_qe(
    params: HestonParams,
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
    sampler: str = "pseudo",
    barrier=None,
    barrier_direction: str = "up",
    device=None,
) -> MCPaths:
    """Simulate ``n_paths`` Heston paths to ``maturity`` with the QE scheme.

    With ``antithetic=True`` the second half of the path axis mirrors the
    first (``Z -> -Z``, ``U -> 1 - U``); ``n_paths`` must then be even.
    ``sampler="sobol"`` draws each path as one point of a randomized
    ``2*n_steps``-dimensional Sobol sequence instead (requires
    ``antithetic=False``; ``generator`` draws the randomization).  Returns
    the terminal state and the running average/max/min, enough for
    European, Asian, barrier and lookback payoffs in O(paths) memory.

    With a ``barrier`` level, the result also carries per-path ``survival``:
    the Brownian-bridge probability that the path never touched the barrier
    between monitoring dates, given the simulated skeleton (Gobet's
    conditional continuity correction, with the QE scheme's own conditional
    log-spot variance ``K3 v + K4 v'`` over a step).  A path whose skeleton
    crosses gets 0, so ``E[payoff * survival]`` estimates the continuously
    monitored knock-out.
    """
    source = _draws(generator, device_of(spot, maturity, *params, default=device))
    dtype, device, dt, consts, theta, drift, s0, ln_s0, v0 = _setup(
        params, spot, maturity, rate, dividend, n_steps, n_paths, antithetic, device)
    E, c1, c2, k0_plain, k1, k2, k3, k4 = consts
    n_draw = n_paths // 2 if antithetic else n_paths
    xs = _sampler_scan_inputs(sampler, source, n_steps, antithetic, device)
    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_draw, antithetic, martingale_correction, dtype,
        sampler=sampler, n_paths=n_paths,
    )
    survival = None
    if barrier is not None:
        ln_b = torch.log(to_tensor(barrier, dtype, device))

        def survival(ln_s, v, ln_s_new, v_new):
            # one-touch probability of the Brownian bridge between skeleton
            # points, with the step's conditional log-spot variance
            w = torch.clamp_min(k3 * v + k4 * v_new, _TINY)
            if barrier_direction == "up":
                g1, g2 = ln_b - ln_s, ln_b - ln_s_new
            else:
                g1, g2 = ln_s - ln_b, ln_s_new - ln_b
            alive = (g1 > 0.0) & (g2 > 0.0)
            p_no_cross = -torch.expm1(-2.0 * g1 * g2 / w)
            return torch.where(alive, p_no_cross, 0.0)

    return _simulate_stats(qe_step, xs, s0, ln_s0, v0, n_steps, survival)


def simulate_qe_paths(
    params: HestonParams,
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
    sampler: str = "pseudo",
    device=None,
):
    """Stored-path QE simulation: ``(S, v)`` of shape ``(n_steps,
    n_paths)`` at the monitoring dates t_1 .. t_N = maturity (t_0, the
    initial state, is not stored).  O(n_steps * n_paths) memory; it feeds
    backward induction (:mod:`pde_tpu_torch.solvers.lsm`)."""
    source = _draws(generator, device_of(spot, maturity, *params, default=device))
    dtype, device, dt, consts, theta, drift, s0, ln_s0, v0 = _setup(
        params, spot, maturity, rate, dividend, n_steps, n_paths, antithetic, device)
    E, c1, c2, k0_plain, k1, k2, k3, k4 = consts
    n_draw = n_paths // 2 if antithetic else n_paths
    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_draw, antithetic, martingale_correction, dtype,
        sampler=sampler, n_paths=n_paths,
    )
    xs = _sampler_scan_inputs(sampler, source, n_steps, antithetic, device)
    return _simulate_stored(qe_step, xs, ln_s0, v0)


# -- estimators --------------------------------------------------------------

def _mc_estimate(discounted, n_paths, antithetic=False):
    """Mean and standard error of a discounted payoff sample (path axis 0).

    With antithetic sampling the 2N paths are N correlated (path, mirror)
    pairs laid out [first half | mirrored half]; the i.i.d. units are the
    pair means, so each pair is folded first (the price is unchanged).
    """
    if antithetic:
        n = n_paths // 2
        discounted = 0.5 * (discounted[:n] + discounted[n:])
    else:
        n = n_paths
    price = torch.mean(discounted, dim=0)
    stderr = torch.std(discounted, dim=0, correction=1) / math.sqrt(float(n))
    return price, stderr


def _discounted_payoff(paths, payoff_fn, spot, maturity, rate, dividend, control_variate):
    """Discounted (and optionally control-variate-adjusted) payoff matrix.

    Returns ``(y, squeeze)`` with ``y`` always 2-D ``(n, k)``; ``squeeze``
    records whether the payoff was scalar-per-path.
    """
    dtype, device = paths.spot.dtype, paths.spot.device
    T = to_tensor(maturity, dtype, device)
    disc = torch.exp(-to_tensor(rate, dtype, device) * T)
    payoff = payoff_fn(paths)
    payoff = (payoff.to(dtype) if isinstance(payoff, torch.Tensor)
              else torch.as_tensor(payoff, dtype=dtype, device=device))
    y = disc * payoff
    squeeze = y.ndim == 1
    if squeeze:
        y = y[:, None]

    if control_variate:
        x = disc * paths.spot
        x_mean_true = to_tensor(spot, dtype, device) * torch.exp(
            -to_tensor(dividend, dtype, device) * T)
        x_c = x - torch.mean(x)
        var_x = torch.mean(x_c * x_c)
        b = torch.mean(x_c[:, None] * (y - torch.mean(y, dim=0)), dim=0) / (var_x + _TINY)
        y = y - b[None, :] * (x[:, None] - x_mean_true)
    return y, squeeze


def price_path_payoff_mc(
    params: HestonParams,
    payoff_fn: Callable[[MCPaths], torch.Tensor],
    spot,
    maturity,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    control_variate: bool = False,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
    device=None,
):
    """Price an arbitrary path payoff ``payoff_fn(MCPaths) -> (n_paths, ...)``.

    Returns ``(price, stderr)``.  With ``control_variate=True`` the
    discounted terminal spot (a discrete martingale under the corrected QE
    scheme, with known mean ``S0 e^{-q T}``) is regressed out of the payoff.

    ``sampler="sobol"`` switches to replicated randomized QMC: the path
    budget is split into ``n_replicates`` independently scrambled Sobol
    batches (antithetic is ignored); the price is the replicate mean and the
    standard error is taken across replicate means.  The replicates run one
    after another, each ``payoff_fn`` call seeing one replicate's ``(m,)``
    fields, as under the reference's ``vmap``.

    ``simulate_fn`` swaps the path generator (the signature of
    :func:`simulate_qe`, ``device=`` included), e.g. the Bates jump-overlay
    simulator; with QMC it must take ``sampler``.
    """
    sim = simulate_fn or simulate_qe
    device = device_of(spot, maturity, *_leaves(params), default=device)
    source = _draws(generator, device)
    if sampler == "sobol":
        if n_paths % n_replicates:
            raise ValueError(
                f"n_paths={n_paths} not divisible by n_replicates={n_replicates}"
            )
        m = n_paths // n_replicates
        means, squeeze = [], None
        for rep in source.split(n_replicates):
            paths = sim(
                params, spot, maturity, rep,
                n_steps=n_steps, n_paths=m, rate=rate, dividend=dividend,
                antithetic=False, sampler="sobol", device=device,
            )
            y, squeeze = _discounted_payoff(
                paths, payoff_fn, spot, maturity, rate, dividend, control_variate)
            means.append(torch.mean(y, dim=0))
        means = torch.stack(means)
        price = torch.mean(means, dim=0)
        stderr = torch.std(means, dim=0, correction=1) / math.sqrt(float(n_replicates))
        if squeeze:
            return price[0], stderr[0]
        return price, stderr

    paths = sim(
        params, spot, maturity, source,
        n_steps=n_steps, n_paths=n_paths, rate=rate, dividend=dividend,
        antithetic=antithetic, device=device,
    )
    y, squeeze = _discounted_payoff(
        paths, payoff_fn, spot, maturity, rate, dividend, control_variate)
    price, stderr = _mc_estimate(y, n_paths, antithetic)
    if squeeze:
        return price[0], stderr[0]
    return price, stderr


def _leaves(params):
    """A parameter record's fields, for the device and dtype rules; none
    for ``params=None`` (a ``simulate_fn`` that carries its own model, as
    the local-vol simulator does)."""
    return () if params is None else tuple(params)


def _strike_vector(strikes, params, spot, maturity, device):
    """``strikes`` as an at-least-1-d tensor in the simulation's dtype, or
    its own where that is wider (a float64 strike on a float32 path is
    compared in float64, as in the reference)."""
    dtype = result_dtype(strikes, spot, maturity, *_leaves(params)[:1])
    return torch.atleast_1d(to_tensor(strikes, dtype, device))


def _vanilla_mc(params, strikes, maturity, spot, generator, field, is_call, device, **kw):
    """(price, stderr) of vanillas on one MCPaths field, shaped like
    ``strikes`` (the European and Asian pricers)."""
    device = device_of(spot, maturity, *_leaves(params), default=device)
    generator = _draws(generator, device)
    strikes_a = _strike_vector(strikes, params, spot, maturity, device)
    sign = _sign(is_call, strikes_a.shape, strikes_a.dtype, device)

    def payoff(paths: MCPaths):
        return torch.clamp_min(
            sign[None, :] * (getattr(paths, field)[:, None] - strikes_a[None, :]), 0.0)

    price, stderr = price_path_payoff_mc(params, payoff, spot, maturity, generator,
                                         device=device, **kw)
    if _ndim(strikes) == 0:
        return price[0], stderr[0]
    return price, stderr


def price_european_mc(
    params: HestonParams,
    strikes,
    maturity,
    spot,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    control_variate: bool = True,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
    device=None,
):
    """European vanilla via QE MC; cross-validates the Carr-Madan pricer.
    Returns (price, stderr) shaped like ``strikes``."""
    return _vanilla_mc(
        params, strikes, maturity, spot, generator, "spot", is_call, device,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=control_variate,
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
    )


def price_asian_mc(
    params: HestonParams,
    strikes,
    maturity,
    spot,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    control_variate: bool = True,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
    device=None,
):
    """Arithmetic-average (Asian) option, averaging over the ``n_steps``
    equispaced monitoring dates t_1..t_N = T.  Returns (price, stderr)."""
    return _vanilla_mc(
        params, strikes, maturity, spot, generator, "s_avg", is_call, device,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=control_variate,
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
    )


def price_barrier_mc(
    params: HestonParams,
    strike,
    barrier,
    maturity,
    spot,
    generator,
    *,
    barrier_type: str = "up-and-out",
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
    continuity_correction: bool = False,
    device=None,
):
    """Barrier option via QE MC.  Returns (price, stderr).

    ``barrier_type``: up-and-out / up-and-in / down-and-out / down-and-in.
    By default the *discretely* monitored contract, knocked on the
    ``n_steps`` simulation dates (plus t_0).  ``continuity_correction=True``
    prices the *continuously* monitored contract at the same ``n_steps``,
    each path weighted by its Brownian-bridge no-touch probability (see
    :func:`simulate_qe`); only the built-in QE simulator supports it.
    """
    direction, _, inout = barrier_type.partition("-and-")
    if direction not in ("up", "down") or inout not in ("in", "out"):
        raise ValueError(f"unknown barrier_type {barrier_type!r}")
    sign = 1.0 if is_call else -1.0

    if continuity_correction:
        if simulate_fn is not None:
            raise ValueError(
                "continuity_correction is only supported with the built-in "
                "QE simulator (simulate_fn=None)"
            )
        simulate_fn = functools.partial(
            simulate_qe, barrier=barrier, barrier_direction=direction)

        def payoff(paths: MCPaths):
            vanilla = torch.clamp_min(sign * (paths.spot - strike), 0.0)
            weight = paths.survival if inout == "out" else 1.0 - paths.survival
            return vanilla * weight

    else:

        def payoff(paths: MCPaths):
            if direction == "up":
                knocked = paths.s_max >= barrier
            else:
                knocked = paths.s_min <= barrier
            alive = knocked if inout == "in" else ~knocked
            vanilla = torch.clamp_min(sign * (paths.spot - strike), 0.0)
            return torch.where(alive, vanilla, 0.0)

    return price_path_payoff_mc(
        params, payoff, spot, maturity, generator,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=False,
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
        device=device,
    )


def price_digital_mc(
    params: HestonParams,
    strikes,
    maturity,
    spot,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    kind: str = "cash",
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
    device=None,
):
    """Digital (binary) option via QE MC.  Returns (price, stderr).

    ``kind="cash"`` pays 1 at expiry in the money; ``kind="asset"`` pays
    S_T.  The MC twin of the Gil-Pelaez pricer (models/digital.py), for
    price cross-checks and simulators with no tractable CF.
    """
    if kind not in ("cash", "asset"):
        raise ValueError(f"kind must be 'cash' or 'asset', got {kind!r}")
    device = device_of(spot, maturity, *_leaves(params), default=device)
    generator = _draws(generator, device)
    strikes_a = _strike_vector(strikes, params, spot, maturity, device)
    sign = _sign(is_call, strikes_a.shape, strikes_a.dtype, device)

    def payoff(paths: MCPaths):
        in_money = sign * (paths.spot[:, None] - strikes_a) > 0.0
        unit = paths.spot[:, None] if kind == "asset" else 1.0
        return torch.where(in_money, unit, 0.0)

    price_, se = price_path_payoff_mc(
        params, payoff, spot, maturity, generator,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=(kind == "asset"),
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
        device=device,
    )
    if _ndim(strikes) == 0:
        return price_[0], se[0]
    return price_, se


def price_touch_mc(
    params: HestonParams,
    barrier,
    maturity,
    spot,
    generator,
    *,
    touch: bool = True,
    rate=0.0,
    dividend=0.0,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    sampler: str = "pseudo",
    n_replicates: int = 8,
    continuity_correction: bool = True,
    direction: str | None = None,
    device=None,
):
    """One-touch / no-touch cash digital paying 1 at EXPIRY, via QE MC.
    Returns (price, stderr).

    ``direction`` ("up"/"down") selects the barrier side; the default
    ``None`` infers it from the values (up if the barrier is above spot).
    ``continuity_correction=True`` (default) prices the continuously
    monitored contract by the Brownian-bridge weights of
    :func:`price_barrier_mc`; ``False`` the contract monitored on the
    ``n_steps`` dates.
    """
    if direction is None:
        direction = "up" if float(barrier) > float(spot) else "down"
    elif direction not in ("up", "down"):
        raise ValueError(f"direction must be 'up' or 'down', got {direction!r}")

    if continuity_correction:
        simulate_fn = functools.partial(
            simulate_qe, barrier=barrier, barrier_direction=direction)

        def payoff(paths: MCPaths):
            return 1.0 - paths.survival if touch else paths.survival

    else:
        simulate_fn = None

        def payoff(paths: MCPaths):
            if direction == "up":
                hit = paths.s_max >= barrier
            else:
                hit = paths.s_min <= barrier
            want = hit if touch else ~hit
            return torch.where(want, 1.0, 0.0)

    return price_path_payoff_mc(
        params, payoff, spot, maturity, generator,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=False,
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
        device=device,
    )


def price_lookback_mc(
    params: HestonParams,
    maturity,
    spot,
    generator,
    *,
    strike=None,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
    device=None,
):
    """Lookback option on the discretely monitored extremum.

    ``strike=None`` prices the floating-strike contract (call: ``S_T - min
    S``; put: ``max S - S_T``); a fixed strike prices ``(max S - K)+`` /
    ``(K - min S)+``.  Returns (price, stderr).
    """

    def payoff(paths: MCPaths):
        if strike is None:
            if is_call:
                return paths.spot - paths.s_min
            return paths.s_max - paths.spot
        if is_call:
            return torch.clamp_min(paths.s_max - strike, 0.0)
        return torch.clamp_min(strike - paths.s_min, 0.0)

    return price_path_payoff_mc(
        params, payoff, spot, maturity, generator,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=False,
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
        device=device,
    )


def _fixing_indices(n_steps: int, maturity, times):
    """Map fixing times onto the stored-path row grid t_1 .. t_N.

    ``maturity`` and ``times`` are contract schedule, read on the host.
    Raises if a fixing does not lie (to 1e-9 relative) on the simulation
    grid: silently snapping would bias the forward-vol exposure the
    contract is meant to isolate.
    """
    mat = float(maturity)
    idx = []
    for t in times:
        frac = float(t) / mat
        i = int(round(frac * n_steps))
        if i < 1 or i > n_steps or abs(i / n_steps - frac) > 1e-9:
            raise ValueError(
                f"fixing t={t} not on the n_steps={n_steps} grid of "
                f"maturity={mat}; choose n_steps a multiple of the fixing "
                "schedule"
            )
        idx.append(i - 1)  # stored rows are t_1..t_N
    return idx


def price_forward_start_mc(
    params: HestonParams,
    rel_strikes,
    fixing,
    maturity,
    spot,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    notional=1.0,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_paths_fn=None,
    device=None,
):
    """Forward-start vanilla: pays ``notional * (S_T/S_{t0} - k)^+`` at T,
    with ``fixing`` (= t0) on the time grid.  The QE log-spot increments do
    not depend on the level, so the price is independent of ``spot``.
    Returns ``(price, stderr)`` shaped like ``rel_strikes``."""
    dtype = result_dtype(spot, maturity, params.kappa)
    device = device_of(spot, maturity, *params, default=device)
    sim = simulate_paths_fn or simulate_qe_paths
    s_path, _ = sim(
        params, spot, maturity, _draws(generator, device),
        n_steps=n_steps, n_paths=n_paths, rate=rate, dividend=dividend,
        antithetic=antithetic, device=device,
    )
    (i_fix,) = _fixing_indices(n_steps, maturity, [fixing])
    ratio = s_path[-1] / s_path[i_fix]  # (n_paths,)

    k = torch.atleast_1d(to_tensor(rel_strikes, dtype, device))
    sign = _sign(is_call, k.shape, dtype, device)
    disc = torch.exp(-to_tensor(rate, dtype, device) * to_tensor(maturity, dtype, device))
    y = (to_tensor(notional, dtype, device) * disc
         * torch.clamp_min(sign[None, :] * (ratio[:, None] - k[None, :]), 0.0))
    price, stderr = _mc_estimate(y, n_paths, antithetic)
    if _ndim(rel_strikes) == 0:
        return price[0], stderr[0]
    return price, stderr


def price_cliquet_mc(
    params: HestonParams,
    maturity,
    spot,
    generator,
    *,
    n_periods: int = 12,
    local_floor=0.0,
    local_cap=0.08,
    global_floor=0.0,
    global_cap=None,
    notional=1.0,
    rate=0.0,
    dividend=0.0,
    n_steps: int | None = None,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_paths_fn=None,
    device=None,
):
    """Cliquet (ratchet) note: pays ``notional * clip(sum_j clip(S_j/S_{j-1}
    - 1, lf, lc), gf, gc)`` at maturity over ``n_periods`` equal periods, a
    strip of forward-start call spreads.  ``n_steps`` defaults to the
    smallest multiple of ``n_periods`` that is >= 64, so every fixing lies
    on the grid.  Returns ``(price, stderr)`` scalars."""
    if n_steps is None:
        n_steps = max(64, n_periods)
        n_steps = ((n_steps + n_periods - 1) // n_periods) * n_periods
    if n_steps % n_periods:
        raise ValueError(
            f"n_steps={n_steps} must be a multiple of n_periods={n_periods}"
        )
    dtype = result_dtype(spot, maturity, params.kappa)
    device = device_of(spot, maturity, *params, default=device)
    sim = simulate_paths_fn or simulate_qe_paths
    s_path, _ = sim(
        params, spot, maturity, _draws(generator, device),
        n_steps=n_steps, n_paths=n_paths, rate=rate, dividend=dividend,
        antithetic=antithetic, device=device,
    )
    t = functools.partial(to_tensor, dtype=dtype, device=device)
    spp = n_steps // n_periods
    fix = s_path[spp - 1::spp]  # (n_periods, n_paths) at t_1..t_P
    prev = torch.cat([t(spot).expand(1, n_paths), fix[:-1]], dim=0)
    rets = torch.clamp(fix / prev - 1.0, t(local_floor), t(local_cap))
    total = torch.sum(rets, dim=0)
    total = torch.maximum(total, t(global_floor))
    if global_cap is not None:
        total = torch.minimum(total, t(global_cap))
    disc = torch.exp(-t(rate) * t(maturity))
    y = t(notional) * disc * total
    price, stderr = _mc_estimate(y[:, None], n_paths, antithetic)
    return price[0], stderr[0]


def greeks_european_mc(
    params: HestonParams,
    strikes,
    maturity,
    spot,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    control_variate: bool = True,
    device=None,
):
    """Pathwise (AD) Greeks of the QE Monte Carlo European price.

    Forward-mode differentiation of the whole simulation: 7 tangents (spot,
    rate and the five Heston parameters) ride one ``torch.func.jacfwd``
    pass.  The draws are made first, by one pricing on a replay of
    ``generator``; the differentiated function replays them (a random op
    under ``jacfwd`` raises), so price and Greeks share one path set.

    Delta is an exact pathwise estimator.  Parameter Greeks (``vega`` =
    dV/dv0, ``d_kappa``/``d_theta``/``d_sigma``/``d_rho``) differentiate
    through the QE branch *selection* but not the indicator itself, so they
    carry a small O(discretization) bias; ``heston.greeks_ad`` is the exact
    check.  Gamma is not valid pathwise on a kinked payoff.

    Returns a dict of tensors shaped like ``strikes``:
    ``price, stderr, delta, rho, vega, d_kappa, d_theta, d_sigma, d_rho``.
    """
    from ..calibrate.lm import _full_fp32_matmul  # calibrate imports the models

    dtype = result_dtype(spot, maturity, params.kappa)
    device = device_of(spot, maturity, *params, default=device)
    replay = _Replay(_draws(generator, device))
    strikes_a = _strike_vector(strikes, params, spot, maturity, device)

    # (1,)-shaped leaves: under jacfwd a 0-d float32 tangent times a Python
    # number comes out float64
    def leaf(x):
        return to_tensor(x, dtype, device).reshape(1)

    p_cast = params._replace(**{f: leaf(getattr(params, f)) for f in params._fields})
    kw = dict(dividend=dividend, is_call=is_call, n_steps=n_steps, n_paths=n_paths,
              antithetic=antithetic, control_variate=control_variate, device=device)

    def price_fn(spot_, params_, rate_):
        p, _ = price_european_mc(params_, strikes_a, maturity, spot_, replay, rate=rate_, **kw)
        return torch.atleast_1d(p)

    with _full_fp32_matmul():  # one forward-AD region at a time in the process
        price, stderr = price_european_mc(p_cast, strikes_a, maturity, leaf(spot), replay,
                                          rate=leaf(rate), **kw)
        d_spot, d_params, d_rate = torch.func.jacfwd(price_fn, argnums=(0, 1, 2))(
            leaf(spot), p_cast, leaf(rate))
    out = {
        "price": price,
        "stderr": stderr,
        "delta": d_spot[..., 0],
        "rho": d_rate[..., 0],
        "vega": d_params.v0[..., 0],  # dV/dv0, matching greeks_ad's convention
        "d_kappa": d_params.kappa[..., 0],
        "d_theta": d_params.theta[..., 0],
        "d_sigma": d_params.sigma[..., 0],
        "d_rho": d_params.rho[..., 0],
    }
    if _ndim(strikes) == 0:
        out = {k: v[0] if v.ndim else v for k, v in out.items()}
    return out
