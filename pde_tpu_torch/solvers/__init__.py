"""PDE solvers: the Heston ADI scan, single-option and book paths, the
local-vol and Black-Scholes 1D solvers, the LCP (obstacle) solvers and the
HJB optimal-stopping solver."""

from . import bs_pde, heston_adi, hjb, lcp, local_vol_pde  # noqa: F401
