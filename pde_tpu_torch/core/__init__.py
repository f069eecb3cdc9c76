"""Core numerics: precision policy and functional grids."""

from . import grids, precision  # noqa: F401
