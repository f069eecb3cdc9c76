"""PDE solvers: the fused Douglas ADI Heston book, the local-vol and the
Black-Scholes 1D books."""

from . import bs_pde, heston_adi, local_vol_pde  # noqa: F401
