"""PDE solvers: the fused Douglas ADI Heston book."""

from . import heston_adi  # noqa: F401
