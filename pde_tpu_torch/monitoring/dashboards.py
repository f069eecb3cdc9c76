"""Grafana dashboards-as-code.

Plain copy of ``pde_tpu/monitoring/dashboards.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference monitoring/dashboards.py: panel/dashboard builders for
the trading, risk, system and data-quality dashboards (:220-860) plus a
file-based provisioner.  Output is Grafana's JSON model, so the artifacts
drop straight into a provisioning directory.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

__all__ = [
    "panel",
    "timeseries_panel",
    "stat_panel",
    "dashboard",
    "create_trading_dashboard",
    "create_risk_dashboard",
    "create_system_dashboard",
    "create_data_quality_dashboard",
    "DashboardProvisioner",
]

_PANEL_ID = [0]


def panel(title: str, panel_type: str, exprs: List[str], unit: str = "short",
          width: int = 12, height: int = 8) -> Dict:
    _PANEL_ID[0] += 1
    return {
        "id": _PANEL_ID[0],
        "title": title,
        "type": panel_type,
        "gridPos": {"w": width, "h": height, "x": 0, "y": 0},
        "fieldConfig": {"defaults": {"unit": unit}},
        "targets": [{"expr": e, "refId": chr(65 + i)} for i, e in enumerate(exprs)],
    }


def timeseries_panel(title: str, exprs: List[str], unit: str = "short", **kw) -> Dict:
    return panel(title, "timeseries", exprs, unit, **kw)


def stat_panel(title: str, expr: str, unit: str = "short", **kw) -> Dict:
    return panel(title, "stat", [expr], unit, **kw)


def dashboard(title: str, panels: List[Dict], uid: Optional[str] = None,
              refresh: str = "30s", tags: Optional[List[str]] = None) -> Dict:
    # lay panels on a 24-wide grid, two per row
    for i, p in enumerate(panels):
        p["gridPos"]["x"] = (i % 2) * 12
        p["gridPos"]["y"] = (i // 2) * 8
    return {
        "uid": uid or title.lower().replace(" ", "-"),
        "title": title,
        "tags": tags or ["pde-tpu"],
        "timezone": "utc",
        "refresh": refresh,
        "schemaVersion": 39,
        "panels": panels,
    }


def create_trading_dashboard() -> Dict:
    """Orders/PnL/positions (dashboards.py:220-400)."""
    return dashboard(
        "Trading Overview",
        [
            stat_panel("Portfolio Value", "qt_portfolio_value", unit="currencyUSD"),
            stat_panel("Daily PnL", "qt_daily_pnl", unit="currencyUSD"),
            timeseries_panel("PnL", ["qt_daily_pnl", "qt_unrealized_pnl"], unit="currencyUSD"),
            timeseries_panel("Orders", [
                "rate(qt_orders_submitted_total[5m])",
                "rate(qt_orders_filled_total[5m])",
                "rate(qt_orders_rejected_total[5m])",
            ]),
            timeseries_panel("Signals by strategy",
                             ["sum by (strategy) (rate(qt_signals_generated_total[15m]))"]),
            stat_panel("Open Positions", "qt_open_positions"),
        ],
        uid="pde-tpu-trading",
    )


def create_risk_dashboard() -> Dict:
    """VaR/Greeks/drawdown (dashboards.py:401-560)."""
    return dashboard(
        "Risk",
        [
            stat_panel("95% VaR", "qt_var_95", unit="currencyUSD"),
            stat_panel("Drawdown", "qt_current_drawdown", unit="percentunit"),
            timeseries_panel("Drawdown", ["qt_current_drawdown"], unit="percentunit"),
            timeseries_panel("Greeks", ["qt_portfolio_delta", "qt_portfolio_vega"]),
            timeseries_panel("Exposure", ["qt_gross_exposure"], unit="currencyUSD"),
            stat_panel("Sharpe (rolling)", "qt_sharpe_ratio"),
        ],
        uid="pde-tpu-risk",
    )


def create_system_dashboard() -> Dict:
    """Latency/errors (dashboards.py:561-700)."""
    return dashboard(
        "System",
        [
            stat_panel("Up", "qt_system_up"),
            timeseries_panel("Errors", ["sum by (component) (rate(qt_system_errors_total[5m]))"]),
            timeseries_panel("Signal latency p95",
                             ["histogram_quantile(0.95, rate(qt_signal_latency_seconds_bucket[5m]))"],
                             unit="s"),
            timeseries_panel("Order latency p95",
                             ["histogram_quantile(0.95, rate(qt_order_latency_seconds_bucket[5m]))"],
                             unit="s"),
            timeseries_panel("Calibration wall time",
                             ["histogram_quantile(0.95, rate(qt_calibration_latency_seconds_bucket[15m]))"],
                             unit="s"),
        ],
        uid="pde-tpu-system",
    )


def create_data_quality_dashboard() -> Dict:
    """Data pipeline health (dashboards.py:701-860)."""
    return dashboard(
        "Data Quality",
        [
            timeseries_panel("Validation errors",
                             ["sum by (check) (rate(qt_data_quality_errors_total[15m]))"]),
            timeseries_panel("Ingestion latency p95",
                             ["histogram_quantile(0.95, rate(qt_data_ingestion_latency_seconds_bucket[5m]))"],
                             unit="s"),
            timeseries_panel("Calibration RMSE",
                             ["qt_calibration_rmse"]),
        ],
        uid="pde-tpu-data",
    )


class DashboardProvisioner:
    """Writes dashboard JSON into a Grafana provisioning directory."""

    DEFAULT_DASHBOARDS = (
        create_trading_dashboard,
        create_risk_dashboard,
        create_system_dashboard,
        create_data_quality_dashboard,
    )

    def __init__(self, output_dir: str):
        self.output_dir = Path(output_dir)

    def provision(self, dashboards: Optional[List[Dict]] = None) -> List[Path]:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        dashboards = dashboards or [f() for f in self.DEFAULT_DASHBOARDS]
        paths = []
        for d in dashboards:
            path = self.output_dir / f"{d['uid']}.json"
            path.write_text(json.dumps(d, indent=1))
            paths.append(path)
        return paths
