"""Functional spatial grids for PDE solvers (twin of ``pde_tpu/core/grids.py``).

Grids are plain tensors made by pure constructors; lookup and interpolation
are pure functions.  Where the reference vmaps a per-grid function over a
book of options, these take the batch as leading dimensions: a grid of
shape ``(..., n)`` pairs with points of shape ``(...)``, and a 1-D grid is
shared by every point.
"""

from __future__ import annotations

import math

import torch

from .precision import default_float, resolve_device

__all__ = [
    "uniform_grid",
    "log_grid",
    "uniform_step",
    "linspace",
    "find_index",
    "interp_linear",
    "price_delta_gamma",
    "interp_bilinear",
    "take",
    "take2",
]


def uniform_grid(x_min: float, x_max: float, n_points: int, dtype=None,
                 device=None) -> torch.Tensor:
    """Uniformly spaced grid of ``n_points`` points on [x_min, x_max], on
    ``device`` (default: the CUDA card)."""
    if n_points < 3:
        raise ValueError("grid requires at least 3 points")
    if not (x_min < x_max):
        raise ValueError("x_min must be less than x_max")
    return torch.linspace(x_min, x_max, n_points,
                          dtype=dtype or default_float(),
                          device=resolve_device(device))


def log_grid(x_min: float, x_max: float, n_points: int, dtype=None,
             device=None) -> torch.Tensor:
    """Grid of ``n_points`` points uniform in log(x) on [x_min, x_max], on
    ``device`` (default: the CUDA card): more resolution near small x.
    Matches the reference's log-space grid (src/cpp/solvers/pde_core.hpp:57-64)."""
    if n_points < 3:
        raise ValueError("grid requires at least 3 points")
    if x_min <= 0:
        raise ValueError("log grid requires x_min > 0")
    if not (x_min < x_max):
        raise ValueError("x_min must be less than x_max")
    return torch.exp(torch.linspace(math.log(x_min), math.log(x_max), n_points,
                                    dtype=dtype or default_float(),
                                    device=resolve_device(device)))


def uniform_step(grid: torch.Tensor, log_space: bool = False) -> torch.Tensor:
    """Uniform step in the grid's natural coordinate: in log coordinates
    for a log-space grid (src/cpp/solvers/pde_core.hpp:89-94)."""
    n = grid.shape[-1]
    if log_space:
        return torch.log(grid[..., -1] / grid[..., 0]) / (n - 1)
    return (grid[..., -1] - grid[..., 0]) / (n - 1)


def linspace(start: torch.Tensor, stop: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` points from ``start`` to ``stop`` along a new last axis, spaced
    as ``jnp.linspace`` spaces them: ``start (1 - s) + stop s`` with
    s = i / (n - 1), and the last point ``stop`` itself.  Endpoints of
    shape (...) give (..., n); built by arithmetic, so gradients reach both
    endpoints."""
    step = torch.arange(n - 1, dtype=start.dtype, device=start.device) / (n - 1)
    head = start[..., None] * (1.0 - step) + stop[..., None] * step
    return torch.cat([head, stop[..., None].expand(head.shape[:-1] + (1,))], -1)


def _as_points(grid: torch.Tensor, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=grid.dtype, device=grid.device)


def _search_right(grid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``searchsorted(grid, x, side="right")`` for a shared 1-D grid or a
    batch of grids ``(..., n)`` against points ``(...)``."""
    if grid.dim() == 1:
        return torch.searchsorted(grid, x.reshape(-1), right=True).reshape(x.shape)
    x = x.expand(grid.shape[:-1])
    return torch.searchsorted(grid.contiguous(), x.unsqueeze(-1).contiguous(),
                              right=True).squeeze(-1)


def take(grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``grid[idx]`` per batch entry."""
    if grid.dim() == 1:
        return grid[idx]
    return torch.gather(grid, -1, idx.unsqueeze(-1)).squeeze(-1)


def take2(values: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``values[..., i, j]`` per batch entry, ``values`` of shape (..., nx, ny)."""
    nx, ny = values.shape[-2:]
    flat = values.reshape(*values.shape[:-2], nx * ny)
    k = i * ny + j
    if flat.dim() == 1:
        return flat[k]
    return torch.gather(flat, -1, k.unsqueeze(-1)).squeeze(-1)


def find_index(grid: torch.Tensor, x) -> torch.Tensor:
    """Index of the grid point closest to ``x``.

    Mirrors Grid1D::find_index (src/cpp/solvers/pde_core.hpp:102-118): clamps
    to the ends and returns the *closer* of the two bracketing points.
    """
    x = _as_points(grid, x)
    n = grid.shape[-1]
    hi = torch.clamp(_search_right(grid, x), 1, n - 1)
    lo = hi - 1
    x = x.expand(hi.shape)
    closer_lo = (x - take(grid, lo)) < (take(grid, hi) - x)
    idx = torch.where(closer_lo, lo, hi)
    idx = torch.where(x <= grid[..., 0], torch.zeros_like(idx), idx)
    idx = torch.where(x >= grid[..., n - 1], torch.full_like(idx, n - 1), idx)
    return idx


def interp_linear(grid: torch.Tensor, values: torch.Tensor, x) -> torch.Tensor:
    """Linear interpolation of ``values`` on ``grid`` at ``x``, clamped to the
    boundary values outside the grid (``jnp.interp`` semantics, matching
    Grid1D::interpolate, src/cpp/solvers/pde_core.hpp:123-133)."""
    x = _as_points(grid, x)
    n = grid.shape[-1]
    i = torch.clamp(_search_right(grid, x), 1, n - 1)
    x = x.expand(i.shape)
    x0, x1 = take(grid, i - 1), take(grid, i)
    f0, f1 = take(values, i - 1), take(values, i)
    dx = x1 - x0
    f = torch.where(dx == 0, f1, f0 + ((x - x0) / dx) * (f1 - f0))
    f = torch.where(x < grid[..., 0], values[..., 0], f)
    return torch.where(x > grid[..., n - 1], values[..., n - 1], f)


def price_delta_gamma(grid: torch.Tensor, values: torch.Tensor, x):
    """Price, delta and gamma at ``x`` from values on a 1D grid: the
    bracketing interpolation, then central differences around the nearest
    interior node (black_scholes_pde.hpp:292-312, the reference's 1D
    readout).  Batches as :func:`interp_linear`."""
    price = interp_linear(grid, values, x)
    n = grid.shape[-1]
    i = torch.clamp(find_index(grid, x), 1, n - 2)
    v_at = lambda d: take(values, i + d)  # noqa: E731
    s_at = lambda d: take(grid, i + d)    # noqa: E731
    delta = (v_at(1) - v_at(-1)) / (s_at(1) - s_at(-1))
    davg = 0.5 * (s_at(1) - s_at(-1))
    gamma = (v_at(1) - 2.0 * v_at(0) + v_at(-1)) / (davg * davg)
    return price, delta, gamma


def interp_bilinear(x_grid: torch.Tensor, y_grid: torch.Tensor,
                    values: torch.Tensor, x, y) -> torch.Tensor:
    """Bilinear interpolation on a tensor-product grid.

    ``values`` has shape (..., nx, ny).  Serves the role of
    HestonPDESolver::interpolate_2d (src/cpp/solvers/heston_pde.hpp:481-504)
    with the true enclosing cell, not the reference's snap to the closest
    grid point.
    """
    x = _as_points(x_grid, x)
    y = _as_points(y_grid, y)
    nx = x_grid.shape[-1]
    ny = y_grid.shape[-1]

    i = torch.clamp(_search_right(x_grid, x), 1, nx - 1)
    j = torch.clamp(_search_right(y_grid, y), 1, ny - 1)
    shape = torch.broadcast_shapes(i.shape, j.shape)
    i, j = i.expand(shape), j.expand(shape)
    x, y = x.expand(shape), y.expand(shape)

    tx = (x - take(x_grid, i - 1)) / (take(x_grid, i) - take(x_grid, i - 1))
    ty = (y - take(y_grid, j - 1)) / (take(y_grid, j) - take(y_grid, j - 1))
    tx = torch.clamp(tx, 0.0, 1.0)
    ty = torch.clamp(ty, 0.0, 1.0)

    return (
        (1 - tx) * (1 - ty) * take2(values, i - 1, j - 1)
        + tx * (1 - ty) * take2(values, i, j - 1)
        + (1 - tx) * ty * take2(values, i - 1, j)
        + tx * ty * take2(values, i, j)
    )
