"""Observability: metrics, health, alerts, logging, diagnostics,
attribution, dashboards, runbooks."""

from . import (  # noqa: F401
    alerts,
    attribution,
    dashboards,
    diagnostics,
    health,
    logging,
    metrics,
    runbooks,
)
from .alerts import AlertManager  # noqa: F401
from .health import HealthManager  # noqa: F401
