"""PDE solvers: the Heston ADI scan, single-option and book paths, the
local-vol and Black-Scholes 1D solvers, the LCP (obstacle) solvers, the
HJB optimal-stopping solver and Longstaff-Schwartz American Monte Carlo with
its dual bound."""

from . import bs_pde, heston_adi, hjb, lcp, local_vol_pde, lsm, lsm_dual  # noqa: F401
