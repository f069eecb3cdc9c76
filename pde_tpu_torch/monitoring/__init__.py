"""Observability: structured logging, the metrics registry, alerts and the
health manager (the reference's diagnostics, attribution, dashboards and
runbooks are left out of the port)."""

from . import alerts, health, logging, metrics  # noqa: F401
from .alerts import AlertManager  # noqa: F401
from .health import HealthManager  # noqa: F401
