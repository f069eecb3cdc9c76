"""Core: precision policy, functional grids, Sobol' QMC and configuration."""

from . import config, grids, precision, qmc  # noqa: F401
