"""Distributed tridiagonal solves: implicit PDE sweeps along a SHARDED axis
(twin of ``pde_tpu/parallel/dist_tridiag.py``).

The reference solves a system whose row axis is split over P devices by
Wang's partitioned Thomas: two serial ``lax.scan`` sweeps over the local
rows, one ``all_gather`` of each block's two edge equations, a (2P x 2P)
interface system solved the same way on every device, and an elementwise
back substitution.  A row loop of that kind would be one launch a row and
a step here, so the port writes the same partitioned algorithm in its
SPIKE form:

1. *Local solve.*  Block p holds rows with ``a_i x_{i-1} + b_i x_i +
   c_i x_{i+1} = d_i``; its first row couples to the left block's last
   unknown x_L through a_0, its last row to the right block's first
   unknown x_R through c_{m-1}.  One batched call of
   :func:`pde_tpu_torch.ops.tridiag.tridiagonal_solve` solves the block's
   own tridiagonal matrix T for three right-hand sides at once, d,
   -a_0 e_0 and -c_{m-1} e_{m-1}, giving g, w_L and w_R, so that
   ``x = g + w_L x_L + w_R x_R``.  On float32 2D batches on the card that
   call is one launch of the hand-written K5 (``csrc/thomas_batched.cu``).
2. *Interface system.*  Rows 0 and m-1 of every block then couple only
   edge unknowns: ``x_0 - w_L[0] x_L - w_R[0] x_R = g_0`` and the same at
   m-1, the reference's reduced equations with (ã, b́, c̃, d́) = (-w_L, 1,
   -w_R, g).  One ``all_gather`` of those 8 numbers a system builds the
   (2P x 2P) system, which every rank solves the same way, in float64, by
   the reference's pivot-free elimination (:func:`_solve_small_nopivot`).
3. *Back substitution*: elementwise, ``x = g + w_L x_L + w_R x_R``.

The collective runs over the process group of the mesh dimension
``axis_name`` of the mesh in use (:func:`.mesh.using_mesh`).  Stable for
the diagonally dominant systems the CN/ADI/implicit-obstacle
discretizations produce (as the reference).  At P = 1 there is no
neighbour: the solve is step 1 for d alone, one batched call (one K5
launch on the card), with no interface system.

Entry points:

* :func:`partitioned_thomas_spmd` — call on every rank of the axis with
  its local row-aligned bands; returns the local solution slice.
* :func:`dist_tridiagonal_solve` — global arrays in the ``ops.tridiag``
  band convention, sharded solve, global result on every rank.  Its one
  collective is one ``all_gather`` of every block's (g, w_L, w_R): each
  rank then builds the interface system from the blocks' edge rows and
  back-substitutes every block itself, so the gathered result needs no
  second collective.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.tridiag import tridiagonal_solve
from .mesh import _global, _mesh_in_use, all_gather, axis_index, axis_size, mesh_device, \
    using_mesh

__all__ = ["partitioned_thomas_spmd", "dist_tridiagonal_solve"]


def _solve_small_nopivot(M, r, n: int):
    """Batched dense solve of an (..., n, n) system, unrolled Gaussian
    elimination WITHOUT pivoting (the reference's own small solve).

    No pivoting is safe here — the reduced system inherits diagonal
    dominance from the PDE operators — and it needs no LAPACK call on the
    card.  n is small (2 x axis size), so the n-step loop is a handful of
    batched vector ops.
    """
    for k in range(n - 1):
        piv = M[..., k, k]
        f = M[..., k + 1:, k] / piv[..., None]                       # (..., n-k-1)
        M = torch.cat([M[..., :k + 1, :], M[..., k + 1:, :] - f[..., None] * M[..., k:k + 1, :]],
                      dim=-2)
        r = torch.cat([r[..., :k + 1], r[..., k + 1:] - f * r[..., k:k + 1]], dim=-1)
    xs = [None] * n
    for k in range(n - 1, -1, -1):
        resid = r[..., k]
        for j in range(k + 1, n):
            resid = resid - M[..., k, j] * xs[j]
        xs[k] = resid / M[..., k, k]
    return torch.stack(xs, dim=-1)


def _interface_solve(red_all, ndev: int):
    """The reduced system of every block's two edge equations.

    ``red_all`` (P, 2, 4, B...) holds, for each block, rows [ã, b́, c̃, d́]
    of its first and last local row.  Unknown order: [x_0^0, x_{m-1}^0,
    x_0^1, x_{m-1}^1, ...].  Returns y (B..., 2P) in float64."""
    ra = torch.movedim(red_all.double(), (0, 1, 2), (-3, -2, -1))   # (B..., P, 2, 4)
    batch = ra.shape[:-3]
    n2 = 2 * ndev
    M = torch.zeros(batch + (n2, n2), dtype=torch.float64, device=ra.device)
    r = torch.zeros(batch + (n2,), dtype=torch.float64, device=ra.device)
    for p in range(ndev):
        # equation 2p   (row 0 of block p):   ã·y[2p-1] + b́·y[2p]   + c̃·y[2p+2]
        # equation 2p+1 (row m-1 of block p): ã·y[2p-1] + b́·y[2p+1] + c̃·y[2p+2]
        e0, e1 = 2 * p, 2 * p + 1
        if p > 0:
            M[..., e0, 2 * p - 1] = ra[..., p, 0, 0]
            M[..., e1, 2 * p - 1] = ra[..., p, 1, 0]
        M[..., e0, 2 * p] = ra[..., p, 0, 1]
        M[..., e1, 2 * p + 1] = ra[..., p, 1, 1]
        if p < ndev - 1:
            M[..., e0, 2 * p + 2] = ra[..., p, 0, 2]
            M[..., e1, 2 * p + 2] = ra[..., p, 1, 2]
        r[..., e0] = ra[..., p, 0, 3]
        r[..., e1] = ra[..., p, 1, 3]
    return _solve_small_nopivot(M, r, n2)


def partitioned_thomas_spmd(a, b, c, d, axis_name: str):
    """Solve a tridiagonal system whose row axis is sharded over
    ``axis_name`` (a dimension of the mesh in use).

    Every rank of that dimension calls it with its LOCAL band slices in
    row-aligned form (each shape ``(..., m)`` with broadcastable batch
    dims; the global system is the concatenation over the axis):

      a[..., i] multiplies x[i-1]   (a at the global first row must be 0)
      b[..., i] multiplies x[i]
      c[..., i] multiplies x[i+1]   (c at the global last row must be 0)
      d[..., i] right-hand side

    Returns the local ``(..., m)`` solution slice.
    """
    mesh = _mesh_in_use(axis_name)
    ndev, idx = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    m = d.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1], c.shape[:-1], d.shape[:-1])
    a, b, c, d = (x.expand(batch + (m,)) for x in (a, b, c, d))
    nb = int(np.prod(batch, dtype=np.int64))
    if ndev == 1:  # no neighbour: the local solve of d alone, as one 2D batch
        a, b, c, d = (x.reshape(nb, m) for x in (a, b, c, d))
        return tridiagonal_solve(a[:, 1:], b, c[:, :-1], d).reshape(batch + (m,))
    g, w_l, w_r = _local_solve(a, b, c, d, nb)
    red_all = all_gather(_reduced(g, w_l, w_r)[None], mesh, axis_name)   # (P, 2, 4, B...)
    y = _interface_solve(red_all, ndev).to(d.dtype)                      # (B..., 2P)
    return _back_substitute(y, idx, ndev, g, w_l, w_r)


def _local_solve(a, b, c, d, nb: int):
    """T [g, w_L, w_R] = [d, -a_0 e_0, -c_{m-1} e_{m-1}] for the block's own
    matrix T, as one batched call of three right-hand sides a system."""
    m = d.shape[-1]
    zero = torch.zeros_like(d)
    e_l = torch.cat([-a[..., :1], zero[..., 1:]], dim=-1)
    e_r = torch.cat([zero[..., :-1], -c[..., -1:]], dim=-1)
    rhs = torch.stack([d, e_l, e_r])                                  # (3, B..., m)
    bands = [x.unsqueeze(0).expand(rhs.shape).reshape(3 * nb, m)
             for x in (a, b, c)]
    sol = tridiagonal_solve(bands[0][:, 1:], bands[1], bands[2][:, :-1],
                            rhs.reshape(3 * nb, m)).reshape(rhs.shape)
    return sol[0], sol[1], sol[2]                                     # (B..., m) each


def _reduced(g, w_l, w_r):
    """A block's two edge equations [ã, b́, c̃, d́] = [-w_L, 1, -w_R, g] at its
    first and last row: (2, 4, B...)."""
    one = torch.ones_like(g[..., 0])
    return torch.stack([
        torch.stack([-w_l[..., 0], one, -w_r[..., 0], g[..., 0]]),
        torch.stack([-w_l[..., -1], one, -w_r[..., -1], g[..., -1]]),
    ])


def _back_substitute(y, p: int, ndev: int, g, w_l, w_r):
    """Block p's solution ``x = g + w_L x_L + w_R x_R`` from the interface
    unknowns y (B..., 2P)."""
    zero = torch.zeros_like(g[..., 0])
    x_l = y[..., 2 * p - 1] if p > 0 else zero
    x_r = y[..., 2 * p + 2] if p < ndev - 1 else zero
    return g + w_l * x_l[..., None] + w_r * x_r[..., None]


def dist_tridiagonal_solve(lower, diag, upper, rhs, mesh, axis: str | None = None):
    """Distributed solve: global bands, the system axis sharded over
    ``axis`` (default the mesh's first dimension), the global solution on
    every rank.

    Band convention matches :func:`pde_tpu_torch.ops.tridiag.thomas`:
      lower (..., n-1), diag (..., n), upper (..., n-1), rhs (..., n).
    Batch axes are replicated; n must be divisible by the axis size.  The
    work runs on the mesh's device in ``rhs``'s floating dtype (float64
    arrays stay float64).
    """
    axis = axis or mesh.mesh_dim_names[0]
    dev = mesh_device(mesh)
    rhs_t = torch.as_tensor(np.asarray(rhs) if not isinstance(rhs, torch.Tensor) else rhs)
    dtype = rhs_t.dtype if rhs_t.is_floating_point() else torch.get_default_dtype()
    rhs, lower, diag, upper = (_global(x, dtype, dev) for x in (rhs_t, lower, diag, upper))
    n = rhs.shape[-1]
    ndev = axis_size(mesh, axis)
    if n % ndev != 0:
        raise ValueError(f"system length {n} not divisible by axis size {ndev}")
    batch = torch.broadcast_shapes(lower.shape[:-1], diag.shape[:-1], upper.shape[:-1],
                                   rhs.shape[:-1])

    # row-aligned global bands: a[0] = 0, c[n-1] = 0
    zero = torch.zeros(batch + (1,), dtype=dtype, device=dev)
    a = torch.cat([zero, lower.expand(batch + (n - 1,))], -1)
    c = torch.cat([upper.expand(batch + (n - 1,)), zero], -1)
    b, d = diag.expand(batch + (n,)), rhs.expand(batch + (n,))
    m, i = n // ndev, axis_index(mesh, axis)
    cols = slice(i * m, (i + 1) * m)
    a, b, c, d = (x[..., cols] for x in (a, b, c, d))
    if ndev == 1:
        with using_mesh(mesh):
            return partitioned_thomas_spmd(a, b, c, d, axis)
    # one all_gather of every block's (g, w_L, w_R): each rank then solves
    # the interface system and back-substitutes every block itself
    nb = int(np.prod(batch, dtype=np.int64))
    parts = all_gather(torch.stack(_local_solve(a, b, c, d, nb))[None], mesh, axis)
    red_all = torch.stack([_reduced(*parts[p]) for p in range(ndev)])   # (P, 2, 4, B...)
    y = _interface_solve(red_all, ndev).to(dtype)
    return torch.cat([_back_substitute(y, p, ndev, *parts[p]) for p in range(ndev)], dim=-1)
