"""PDE solvers: the Heston ADI scan, single-option and book paths, the
local-vol and Black-Scholes 1D solvers, the LCP (obstacle) solvers, the
HJB optimal-stopping solver, the Merton/Kou PIDE, the Bates 2D PIDE, the
Heston barrier solver, Longstaff-Schwartz American Monte Carlo with its
dual bound, and the Hull-White (PDE and Monte Carlo) and G2++ (Monte
Carlo) Bermudan swaption engines."""

from . import (  # noqa: F401
    barrier_pde,
    bates_pide,
    bermudan_g2,
    bermudan_hw,
    bs_pde,
    heston_adi,
    hjb,
    lcp,
    local_vol_pde,
    lsm,
    lsm_dual,
    pide,
)
