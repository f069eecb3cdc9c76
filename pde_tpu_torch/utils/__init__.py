"""Utilities: statistical primitives and matrix helpers."""

from . import linalg, stats  # noqa: F401
