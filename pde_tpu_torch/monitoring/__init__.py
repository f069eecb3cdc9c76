"""Observability: structured logging and the metrics registry (the
reference's alerts and health modules come with ROADMAP A.6f; its
diagnostics, attribution, dashboards and runbooks are left out of the
port)."""

from . import logging, metrics  # noqa: F401
