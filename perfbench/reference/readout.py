"""Grid readouts shared by the PDE references: the node nearest a point,
with the other node of its bracket where the two lie within rounding of
each other, and linear and bilinear interpolation clamped to the grid."""

from __future__ import annotations

import torch

# two nodes closer to the point than this share of their spacing apart are
# a tie: the program, in float32, may take either
TIE = 1e-4


def nearest(grid, x):
    """Index (B,) of the node of ``grid`` (n,) or (B, n) nearest ``x`` (B,)
    clamped to [1, n - 2], and the index the other choice of a tie gives
    (equal to the first where there is no tie)."""
    g = grid if grid.dim() == 2 else grid.expand(x.shape[0], -1)
    n = g.shape[1]
    hi = torch.clamp(torch.searchsorted(g.contiguous(), x[:, None].contiguous(),
                                        right=True)[:, 0], 1, n - 1)
    lo = hi - 1
    d_lo = x - g.gather(1, lo[:, None])[:, 0]
    d_hi = g.gather(1, hi[:, None])[:, 0] - x
    idx = torch.where(d_lo < d_hi, lo, hi)
    alt = torch.where(d_lo < d_hi, hi, lo)
    tie = (d_lo - d_hi).abs() <= TIE * (d_lo + d_hi)
    idx = torch.where(x <= g[:, 0], 0, torch.where(x >= g[:, -1], n - 1, idx))
    alt = torch.where(tie & (x > g[:, 0]) & (x < g[:, -1]), alt, idx)
    return torch.clamp(idx, 1, n - 2), torch.clamp(alt, 1, n - 2)


def bracket(grid, x):
    """Upper node (B,) of the bracket of ``x`` in ``grid`` (B, n) or (n,)
    and the weight of the upper node, clamped to [0, 1]."""
    g = grid if grid.dim() == 2 else grid.expand(x.shape[0], -1)
    n = g.shape[1]
    hi = torch.clamp(torch.searchsorted(g.contiguous(), x[:, None].contiguous(),
                                        right=True)[:, 0], 1, n - 1)
    g0, g1 = g.gather(1, (hi - 1)[:, None])[:, 0], g.gather(1, hi[:, None])[:, 0]
    return hi, torch.clamp((x - g0) / (g1 - g0), 0.0, 1.0)
