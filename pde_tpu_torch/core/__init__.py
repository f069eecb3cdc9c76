"""Core numerics: precision policy, functional grids and Sobol' QMC."""

from . import grids, precision, qmc  # noqa: F401
