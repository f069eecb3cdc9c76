"""Grid-axis sharded PDE stepping with halo exchange (twin of
``pde_tpu/parallel/halo.py``).

The spatial axis is split over the ``grid`` dimension of a mesh; each
explicit stencil step swaps the edge cells with the two neighbouring ranks
(one ``torch.distributed.batch_isend_irecv`` of point-to-point sends and
receives, the counterpart of the reference's two ``lax.ppermute``s).  There
is no wrap-around send: the first and last ranks keep the reference's
global boundary rows, where the stencil's ghost cell is masked out anyway.
The time march is a host loop, one exchange a step.

Demonstrated on the log-space Black-Scholes operator (explicit scheme; the
implicit sweeps pair this with the partitioned Thomas solve,
:mod:`.dist_tridiag`, in :mod:`.adi_sharded`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..core.precision import default_float
from .mesh import all_gather, axis_index, axis_size, make_mesh, mesh_device

__all__ = ["sharded_bs_explicit", "make_grid_mesh"]


def make_grid_mesh(n_devices: int, axis: str = "grid", *, device_type=None):
    """A one-dimensional mesh over ``n_devices`` ranks (the world size)
    named ``axis``; ``device_type`` as :func:`.mesh.make_mesh`."""
    return make_mesh(n_devices, (axis,), (n_devices,), device_type=device_type)


def _exchange_halos(V, mesh, axis: str):
    """Fetch the neighbour edge cells: returns (left_ghost, right_ghost),
    each shaped like ``V[0]``.

    Rank i sends its last row to rank i + 1 and its first row to rank
    i - 1, and receives theirs.  The first rank has no left neighbour and
    the last none on the right: their ghost is zero, and the stencil masks
    it out (Dirichlet boundaries live on the global edges).
    """
    n_dev, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    left_ghost, right_ghost = torch.zeros_like(V[0]), torch.zeros_like(V[0])
    if n_dev == 1:
        return left_ghost, right_ghost
    group = mesh.get_group(axis)
    peer = lambda i: dist.get_global_rank(group, i)  # noqa: E731
    ops = []
    if idx > 0:
        ops += [dist.P2POp(dist.isend, V[0].contiguous(), peer(idx - 1), group),
                dist.P2POp(dist.irecv, left_ghost, peer(idx - 1), group)]
    if idx < n_dev - 1:
        ops += [dist.P2POp(dist.isend, V[-1].contiguous(), peer(idx + 1), group),
                dist.P2POp(dist.irecv, right_ghost, peer(idx + 1), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return left_ghost, right_ghost


def sharded_bs_explicit(
    mesh,
    sigma: float,
    r: float,
    q: float,
    T: float,
    K: float,
    n_space: int,
    n_time: int,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    is_call: bool = True,
    dtype=None,
):
    """Explicit log-space BS march with the S-axis sharded over the mesh.

    Returns (s_grid, V) as global arrays on every rank, on the mesh's
    device in ``dtype`` (torch's default float when None).  n_space must
    be divisible by the mesh size.  Explicit stepping needs dt below the
    CFL bound — callers pick n_time accordingly.
    """
    axis = mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis)
    if n_space % n_dev != 0:
        raise ValueError(f"n_space={n_space} not divisible by mesh size {n_dev}")
    dev, dtype = mesh_device(mesh), dtype or default_float()

    x = np.linspace(np.log(K * s_min_mult), np.log(K * s_max_mult), n_space)
    s_grid = torch.as_tensor(np.exp(x), dtype=dtype, device=dev)
    dx = float(x[1] - x[0])
    dt = T / n_time

    sigma2 = sigma * sigma
    a = 0.5 * sigma2 / (dx * dx)
    b = (r - q - 0.5 * sigma2) / (2.0 * dx)
    L_m, L_c, L_p = a - b, -2.0 * a - r, a + b

    m, idx = n_space // n_dev, axis_index(mesh, axis)
    s_local = s_grid[idx * m:(idx + 1) * m]
    V = (torch.clamp_min(s_local - K, 0.0) if is_call else torch.clamp_min(K - s_local, 0.0))
    is_first, is_last = idx == 0, idx == n_dev - 1
    for k in range(1, n_time + 1):
        tau = dt * k
        lg, rg = _exchange_halos(V, mesh, axis)
        left = torch.cat([lg[None], V[:-1]])
        right = torch.cat([V[1:], rg[None]])
        V = V + dt * (L_m * left + L_c * V + L_p * right)
        # global Dirichlet boundaries, discounted over time-to-expiry with
        # the dividend leg on S (the corrected convention of bs_pde)
        df_r, df_q = math.exp(-r * tau), math.exp(-q * tau)
        if is_first:
            V[0] = 0.0 if is_call else K * df_r - s_local[0] * df_q
        if is_last:
            V[m - 1] = s_local[-1] * df_q - K * df_r if is_call else 0.0
    return s_grid, all_gather(V, mesh, axis)
