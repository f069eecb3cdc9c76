"""HJB optimal-stopping solver for mean-reversion trading (twin of
``pde_tpu/solvers/hjb.py``).

Redesign of the reference HJBSolver (src/cpp/solvers/hjb_solver.hpp): solves

    max{ V_t + mu (theta - x) V_x + 0.5 sigma^2 V_xx - r V,  g(x) - V } = 0

by an implicit time march with the obstacle handled each step (the
reference's time loop, hjb_solver.hpp:163-178).  The four stopping problems
(entry/exit, long/short) use the reference's exercise-value heuristics
(hjb_solver.hpp:258-314); the problem axis is a batch axis, so all four
march together.  Three obstacle methods:

* ``projection`` — central differences, an implicit solve, then
  ``max(V, g)``.  Each step's solve is one
  :func:`~pde_tpu_torch.ops.tridiag.tridiagonal_solve` on the problems'
  (rows, n) batch, bands shared by the problems of one config: on float32
  tensors on the card ONE launch of K5, elsewhere the plain Thomas solve.
  Both eliminate afresh each step, where the reference factors once.
* ``psor`` — upwind differences, the LCP by red-black projected SOR from
  ``x0 = V``: one launch of K6 a step on the card
  (:func:`~pde_tpu_torch.solvers.lcp.projected_sor`).
* ``brennan_schwartz`` — upwind, the same LCP solved exactly: the matrix
  eliminated once, then one projected pass a step (tensor ops a row; the
  reference has no kernel for it).

Boundary detection (where V crosses the payoff) runs on the host on the
final value function.  Entry points run on ``device`` (default: the CUDA
card): ``backend="auto"`` and ``"device"`` both march there.
``"native"`` sends the projection and Brennan-Schwartz marches of
:func:`solve` and :func:`solve_all_boundaries` to the C++ host twin
(:mod:`pde_tpu_torch.native`, float64 on the CPU), and raises when that
library cannot be built; PSOR and ``reference_compat`` march on the device,
as in the reference.  The reference's ``auto`` picks the host twin where
it is built; here ``auto`` stays on the device.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import native
from ..core import grids
from ..core.precision import resolve_device, result_dtype, to_tensor
from ..ops.tridiag import kernel_route, tridiagonal_solve
from . import lcp

__all__ = [
    "StoppingProblem",
    "HJBParams",
    "HJBResult",
    "OptimalTradingBoundaries",
    "solve",
    "solve_all_boundaries",
    "boundaries_batch",
    "extract_boundaries_batch",
]


class StoppingProblem(enum.IntEnum):
    ENTRY_LONG = 0
    ENTRY_SHORT = 1
    EXIT_LONG = 2
    EXIT_SHORT = 3


class HJBParams(NamedTuple):
    """Inputs (defaults match HJBParams, hjb_solver.hpp:61-65)."""

    theta: float = 0.0
    mu: float = 5.0
    sigma: float = 0.1
    r: float = 0.05
    c_entry: float = 0.001
    c_exit: float = 0.001
    T: float = 1.0
    problem: StoppingProblem = StoppingProblem.ENTRY_LONG
    n_space: int = 200
    n_time: int = 200
    x_min: float = -0.5
    x_max: float = 0.5
    # obstacle handling: "projection" = implicit-then-max (the reference's
    # splitting, hjb_solver.hpp:163-178); "psor" = rigorous free-boundary
    # LCP via red-black projected SOR (Leung-Li 2015 formulation);
    # "brennan_schwartz" = the SAME rigorous LCP solved EXACTLY in one
    # projected tridiagonal pass (valid here because every stopping region
    # is anchored at one grid end)
    method: str = "projection"
    psor_iterations: int = 60
    # Replicate the reference matrix assembly exactly (hjb_solver.hpp:354-358
    # zeroes lower[0] and upper[n-2] AFTER the fill loop, so rows 1 and n-2
    # lose their implicit coupling to the extrapolated boundary rows); used
    # by the golden parity tests (tests/golden/reference_pde_values.json).
    reference_compat: bool = False
    # "auto" and "device" march on the device the entry point is given (the
    # CUDA card by default); "native" runs single-config projection and
    # Brennan-Schwartz marches on the C++ host twin (src/cpp/pde_solvers.cpp)
    backend: str = "auto"


class HJBResult(NamedTuple):
    value_function: np.ndarray
    x_grid: np.ndarray
    lower_boundary: Optional[float]
    upper_boundary: Optional[float]
    stop_loss: Optional[float]

    def value_at(self, x: float) -> float:
        return float(np.interp(x, self.x_grid, self.value_function))

    def should_stop(self, x: float) -> bool:
        if self.lower_boundary is not None and x <= self.lower_boundary:
            return True
        if self.upper_boundary is not None and x >= self.upper_boundary:
            return True
        return False


class OptimalTradingBoundaries(NamedTuple):
    entry_long: float
    entry_short: float
    exit_long: float
    exit_short: float
    stop_loss_long: float
    stop_loss_short: float


def _exercise_value(x, p: HJBParams, problem: StoppingProblem):
    """Stopping payoff g(x) per problem (hjb_solver.hpp:258-314) on the
    tensor ``x``; the fields of ``p`` are numbers or tensors that broadcast
    against it.

    Entry payoffs discount the theta-reversion profit by the heuristic
    expected hitting time log(|x - theta| / sigma) / mu (floored at 0).
    """
    dev = torch.abs(x - p.theta)
    safe = torch.clamp_min(dev / p.sigma, 1e-300)
    t_hit = torch.clamp_min(torch.log(safe) / p.mu, 0.0)
    disc = torch.exp(-p.r * t_hit)

    profit_long = torch.where(x >= p.theta, 0.0, (p.theta - x) * disc)
    profit_short = torch.where(x <= p.theta, 0.0, (x - p.theta) * disc)

    if problem == StoppingProblem.ENTRY_LONG:
        return profit_long - p.c_entry
    if problem == StoppingProblem.ENTRY_SHORT:
        return profit_short - p.c_entry
    if problem == StoppingProblem.EXIT_LONG:
        return x - p.c_exit
    return -x - p.c_exit


def _march(exercise, theta, mu, sigma, r, T, x_min, x_max, n_space, n_time,
           method="projection", psor_iterations=60, reference_compat=False,
           bs_reverse=False):
    """Implicit time march with obstacle handling (hjb_solver.hpp:150-190)
    on ``exercise``'s device and dtype.

    ``exercise`` is (n,) for one problem, (P, n) for P problems of one
    config, or (B, P, n) with ``theta``, ``mu``, ``sigma``, ``x_min`` and
    ``x_max`` of shape (B,) for a book of configs, each with its own grid
    and operator.  ``bs_reverse`` is Brennan-Schwartz's sweep direction per
    problem (a bool, or a bool tensor over P).  Returns (x, V).
    """
    f, dev, n = exercise.dtype, exercise.device, n_space
    theta, mu, sigma, x_min, x_max = (to_tensor(a, f, dev)
                                      for a in (theta, mu, sigma, x_min, x_max))
    x = grids.linspace(x_min, x_max, n)
    dx = (x_max - x_min) / (n - 1)
    dt = T / n_time

    # OU generator.  Projection: central differences, matching the
    # reference (hjb_solver.hpp:321-361).  PSOR and Brennan-Schwartz:
    # monotone upwind differencing — the LCP solvers need the M-matrix
    # property, which central advection violates once |drift| dx > sigma^2.
    diff = 0.5 * sigma * sigma
    a = (diff / (dx * dx))[..., None]
    dx = dx[..., None]
    drift = mu[..., None] * (theta[..., None] - x[..., 1:-1])
    if method in ("psor", "brennan_schwartz"):
        L_m = a + torch.clamp_min(-drift, 0.0) / dx
        L_p = a + torch.clamp_min(drift, 0.0) / dx
        L_c = -2.0 * a - torch.abs(drift) / dx - r
    else:
        b = drift / (2.0 * dx)
        L_m = a - b
        L_c = (-2.0 * a - r).expand(drift.shape)
        L_p = a + b

    # boundary rows are identity rows (hjb_solver.hpp:354-358)
    one, zero = torch.ones_like(x[..., :1]), torch.zeros_like(x[..., :1])
    diag = torch.cat([one, 1.0 - dt * L_c, one], -1)
    lower = torch.cat([-dt * L_m, zero], -1)
    upper = torch.cat([zero, -dt * L_p], -1)
    if reference_compat:
        # the reference additionally zeroes A[1,0] and A[n-2,n-1]
        # (lower[0] / upper[n-2] in its band layout)
        lower = torch.cat([zero, lower[..., 1:]], -1)
        upper = torch.cat([upper[..., :-1], zero], -1)
    if exercise.dim() == x.dim() + 1:
        # one operator for the problems of each config
        lower, diag, upper = (t.unsqueeze(-2) for t in (lower, diag, upper))

    psor = method == "psor"
    brennan = method == "brennan_schwartz"
    if brennan:
        factors = lcp.brennan_schwartz_factor(lower, diag, upper,
                                              torch.as_tensor(bs_reverse, device=dev))
    elif not psor:
        # the problems' rows as one (rows, n) batch, so that each step is
        # one solve (one K5 launch on the card); bands of a shared operator
        # are expanded without a copy
        rows = exercise.numel() // n
        bands = [t.expand(exercise.shape[:-1] + t.shape[-1:]).reshape(rows, -1)
                 for t in (lower, diag, upper)]
        on_kernel = kernel_route(exercise, *bands)

    V = exercise
    for _ in range(n_time):
        if psor:
            V, _ = lcp.projected_sor(lower, diag, upper, V, exercise, x0=V,
                                     n_iter=psor_iterations)
        elif brennan:
            V = lcp.brennan_schwartz_apply(factors, V, exercise)
        else:
            V = tridiagonal_solve(*bands, V.reshape(rows, n),
                                  use_kernel=on_kernel).reshape(exercise.shape)
            V = torch.maximum(V, exercise)
        # linear extrapolation boundaries (hjb_solver.hpp:363-368)
        V = torch.cat([2.0 * V[..., 1:2] - V[..., 2:3], V[..., 1:-1],
                       2.0 * V[..., -2:-1] - V[..., -3:-2]], -1)
    return x, V


# Brennan-Schwartz sweep direction per stopping problem: the contact
# (stopping) region is anchored at the LEFT grid end (False) or RIGHT (True).
_BS_REVERSE = {
    StoppingProblem.ENTRY_LONG: False,   # enter long when x is low
    StoppingProblem.ENTRY_SHORT: True,   # enter short when x is high
    StoppingProblem.EXIT_LONG: True,     # exit long when x has risen
    StoppingProblem.EXIT_SHORT: False,   # exit short when x has fallen
}


def _find_boundaries(V: np.ndarray, x: np.ndarray, g: np.ndarray):
    """Continuation/stopping crossings of V - g (hjb_solver.hpp:375-403).

    Vectorized over the grid; like the reference's scan, the LAST crossing of
    each kind wins when there are several.  ``g`` is the payoff the march
    was given, in ``V``'s dtype.  A float64 V - g counts as positive above
    1e-10, as in the reference.  Below float64 a point's zero is two of its
    own ulps: a float32 march extrapolates its end rows in float32, and
    where V = g there 2 V[1] - V[2] misses g[0] by about an ulp of g, which
    1e-10 would read as a crossing at the grid's edge.
    """
    diff = V - g
    tol = (1e-10 if V.dtype == np.float64
           else np.maximum(1e-10, 2.0 * np.finfo(V.dtype).eps * np.abs(g)))
    tol = np.broadcast_to(tol, diff.shape)
    prev, curr = diff[:-1], diff[1:]
    tol_prev, tol_curr = tol[:-1], tol[1:]
    dx_seg = x[1:] - x[:-1]

    lower_bd = upper_bd = None
    down = np.nonzero((prev > tol_prev) & (curr <= tol_curr))[0]
    if down.size:
        i = down[-1]
        t = prev[i] / (prev[i] - curr[i])
        lower_bd = float(x[i] + t * dx_seg[i])
    up = np.nonzero((prev <= tol_prev) & (curr > tol_curr))[0]
    if up.size:
        i = up[-1]
        t = -prev[i] / (curr[i] - prev[i])
        upper_bd = float(x[i] + t * dx_seg[i])
    return lower_bd, upper_bd


def _host_grid_and_payoffs(params: HJBParams, problems) -> tuple:
    """x grid + stacked exercise vectors, float64 on the host."""
    x_np = np.linspace(float(params.x_min), float(params.x_max),
                       params.n_space, dtype=np.float64)
    x = torch.from_numpy(x_np)
    g_np = np.stack([_exercise_value(x, params, pr).numpy() for pr in problems])
    return x_np, g_np


def _setup(params: HJBParams, device, dtype):
    """The checks of :func:`solve`, then the march's device and dtype, or
    None for the C++ host twin: ``backend="native"`` takes the projection
    and Brennan-Schwartz marches there (asking for another device than the
    CPU or another dtype than float64 raises); PSOR and the reference's own
    band march on the device, as in the reference."""
    if params.mu <= 0 or params.sigma <= 0:
        raise ValueError("mu and sigma must be positive")
    if params.r < 0 or params.T <= 0:
        raise ValueError("r must be >= 0 and T > 0")
    if params.n_space < 10:
        raise ValueError("n_space must be >= 10")
    if (params.backend == "native" and not params.reference_compat
            and params.method in ("projection", "brennan_schwartz")):
        if ((device is not None and torch.device(device).type != "cpu")
                or dtype not in (None, torch.float64)):
            raise ValueError(
                f"backend='native' marches {params.method} on the host in float64; "
                f"got device={device!r}, dtype={dtype!r} (use backend='device' for those)")
        return None
    floats = (params.theta, params.mu, params.sigma, params.r, params.T,
              params.x_min, params.x_max)
    return resolve_device(device), dtype or result_dtype(*floats)


def _native_march(params: HJBParams, g_np, problems):
    """The marches of ``problems`` (exercise values ``g_np``, (P, n)) on the
    host twin: Brennan-Schwartz in one call (a thread a march when P > 1),
    projection a call a problem."""
    args = tuple(float(a) for a in (params.theta, params.mu, params.sigma, params.r,
                                    params.T, params.x_min, params.x_max))
    if params.method == "brennan_schwartz":
        rev = [_BS_REVERSE[pr] for pr in problems]
        return native.hjb_march_bs_multi(*args, g_np, rev, n_time=params.n_time)
    return np.stack([native.hjb_march(*args, g, n_time=params.n_time) for g in g_np])


def _run(params: HJBParams, g_np, device, dtype, bs_reverse):
    """The march of ``g_np``'s problems on ``device`` in ``dtype``: V as numpy."""
    _, V = _march(
        torch.as_tensor(g_np, dtype=dtype, device=device), params.theta, params.mu,
        params.sigma, params.r, params.T, params.x_min, params.x_max, params.n_space,
        params.n_time, method=params.method, psor_iterations=params.psor_iterations,
        reference_compat=bool(params.reference_compat), bs_reverse=bs_reverse)
    return V.cpu().numpy()


def solve(params: HJBParams, device=None, dtype=None) -> HJBResult:
    """Solve one stopping problem on ``device`` (default: the CUDA card) in
    ``dtype`` (default: the dtype of the tensors among the parameters, else
    torch's default float), or with ``backend="native"`` on the host twin
    in float64; boundaries extracted on the host."""
    where = _setup(params, device, dtype)
    x_np, g_np = _host_grid_and_payoffs(params, [params.problem])
    if where is None:
        V_np = _native_march(params, g_np, [params.problem])[0]
    else:
        V_np = _run(params, g_np[0], *where, _BS_REVERSE[params.problem])
    lo, hi = _find_boundaries(V_np, x_np, g_np[0].astype(V_np.dtype))
    return HJBResult(V_np, x_np, lo, hi, None)


def solve_all_boundaries(params: HJBParams, device=None,
                         dtype=None) -> OptimalTradingBoundaries:
    """All four stopping problems in ONE batched march (hjb_solver.hpp:199-234),
    on ``device`` and in ``dtype`` or on the host twin as :func:`solve`.

    The reference runs four sequential solves; here the four exercise vectors
    stack on a batch axis and share one operator.  Fallback defaults and the
    2-sigma stop-loss heuristics match the reference exactly.
    """
    where = _setup(params, device, dtype)
    x_np, g_np_all = _host_grid_and_payoffs(params, list(StoppingProblem))
    if where is None:
        V_np = _native_march(params, g_np_all, list(StoppingProblem))
    else:
        V_np = _run(params, g_np_all, *where, [_BS_REVERSE[pr] for pr in StoppingProblem])
    return _assemble_boundaries(params, x_np, V_np, g_np_all.astype(V_np.dtype))


def _assemble_boundaries(params: HJBParams, x_np, V_np, g_np):
    """Boundary detection + reference fallback/stop-loss semantics
    (hjb_solver.hpp:205-232) from the four final value functions; only
    ``theta``, ``mu`` and ``sigma`` of ``params`` are read."""
    sigma_stat = params.sigma / np.sqrt(2.0 * params.mu)

    bounds = {}
    for pr in StoppingProblem:
        lo, hi = _find_boundaries(V_np[pr], x_np, g_np[pr])
        bounds[pr] = (lo, hi)

    entry_long = bounds[StoppingProblem.ENTRY_LONG][0]
    if entry_long is None:
        entry_long = params.theta - 2.0 * sigma_stat
    entry_short = bounds[StoppingProblem.ENTRY_SHORT][1]
    if entry_short is None:
        entry_short = params.theta + 2.0 * sigma_stat
    exit_long = bounds[StoppingProblem.EXIT_LONG][1]
    if exit_long is None:
        exit_long = params.theta
    exit_short = bounds[StoppingProblem.EXIT_SHORT][0]
    if exit_short is None:
        exit_short = params.theta

    return OptimalTradingBoundaries(
        entry_long=entry_long,
        entry_short=entry_short,
        exit_long=exit_long,
        exit_short=exit_short,
        stop_loss_long=entry_long - 2.0 * sigma_stat,
        stop_loss_short=entry_short + 2.0 * sigma_stat,
    )


def boundaries_batch(theta, mu, sigma, r, c_entry, c_exit, T,
                     n_space=200, n_time=200, x_min=None, x_max=None,
                     method="brennan_schwartz", device=None, dtype=None):
    """All four stopping problems for a BOOK of pair configs in one march.

    The reference computes boundaries per pair with four sequential C++
    solves (hjb_solver.hpp:199-234); here ``(theta, mu, sigma)`` are (B,)
    vectors, the (B, 4) problem/config plane is one batch axis, and the
    implicit marches broadcast over it.  Per-config grids default to
    theta +- 15.8 sigma/sqrt(2 mu) (the single-config default's span).  On
    ``device`` (default: the CUDA card) in ``dtype`` (default: the dtype of
    the tensors among theta, mu and sigma, else torch's default float); by
    ``projection`` on float32 on the card each step is one K5 launch on
    (4B, n).

    Returns tensors ``(x_grids (B, n), V (B, 4, n), g (B, 4, n))``; feed to
    :func:`extract_boundaries_batch` for host-side boundary lists.
    """
    device = resolve_device(device)
    dtype = dtype or result_dtype(theta, mu, sigma)
    theta, mu, sigma = (torch.as_tensor(a, dtype=dtype, device=device)
                        for a in (theta, mu, sigma))
    sigma_stat = sigma / torch.sqrt(2.0 * mu)
    x_min = theta - 15.8 * sigma_stat if x_min is None else x_min
    x_max = theta + 15.8 * sigma_stat if x_max is None else x_max
    x_min, x_max = (to_tensor(a, dtype, device).expand(theta.shape) for a in (x_min, x_max))

    x = grids.linspace(x_min, x_max, n_space)
    col = HJBParams(theta=theta[:, None], mu=mu[:, None], sigma=sigma[:, None], r=r,
                    c_entry=c_entry, c_exit=c_exit, T=T)
    g_all = torch.stack([_exercise_value(x, col, pr) for pr in StoppingProblem], 1)
    rev = torch.tensor([_BS_REVERSE[pr] for pr in StoppingProblem], device=device)
    _, V = _march(g_all, theta, mu, sigma, r, T, x_min, x_max, n_space, n_time,
                  method=method, bs_reverse=rev)
    return x, V, g_all


def extract_boundaries_batch(x_grids, V, g, mu, sigma, theta):
    """Host-side boundary extraction for :func:`boundaries_batch` output."""
    x_np, V_np, g_np, mu, sigma, theta = (
        a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        for a in (x_grids, V, g, mu, sigma, theta))
    return [_assemble_boundaries(HJBParams(theta=theta[b], mu=mu[b], sigma=sigma[b]),
                                 x_np[b], V_np[b], g_np[b])
            for b in range(V_np.shape[0])]
