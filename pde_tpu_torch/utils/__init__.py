"""Utilities: statistical primitives."""

from . import stats  # noqa: F401
