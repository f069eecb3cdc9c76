"""PDE solvers: the Heston ADI scan, single-option and book paths, the
local-vol and Black-Scholes 1D solvers, and the LCP (obstacle) solvers."""

from . import bs_pde, heston_adi, lcp, local_vol_pde  # noqa: F401
