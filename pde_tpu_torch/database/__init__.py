"""Persistence: time-series store, model-parameter store, positions."""

from . import db  # noqa: F401
from .db import TimeSeriesDB  # noqa: F401
