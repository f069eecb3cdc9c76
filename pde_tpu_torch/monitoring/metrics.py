"""Prometheus metrics registry with mock fallback.

Plain copy of ``pde_tpu/monitoring/metrics.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference monitoring/metrics.py: the metric inventory (system /
orders / PnL / positions / signals / risk / latency / data quality /
calibration; :103-436), the mock metric classes used when prometheus_client
is absent (:57-95), the ``track_latency`` / ``count_calls`` decorators
(:448-525) and the background MetricsCollector (:527-620).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable, Dict, Optional

__all__ = [
    "PROMETHEUS_AVAILABLE",
    "REGISTRY",
    "track_latency",
    "count_calls",
    "MetricsCollector",
    "get_metric",
]

try:  # pragma: no cover - import guard
    from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram

    PROMETHEUS_AVAILABLE = True
except ImportError:  # pragma: no cover
    PROMETHEUS_AVAILABLE = False

    class _MockMetric:
        """No-op stand-in (metrics.py:57-95)."""

        def __init__(self, *a, **k):
            self._value = 0.0

        def labels(self, *a, **k):
            return self

        def inc(self, amount=1.0):
            self._value += amount

        def dec(self, amount=1.0):
            self._value -= amount

        def set(self, value):
            self._value = value

        def observe(self, value):
            self._value = value

    Counter = Gauge = Histogram = _MockMetric  # type: ignore

    class CollectorRegistry:  # type: ignore
        pass


REGISTRY = CollectorRegistry() if PROMETHEUS_AVAILABLE else None
_KW = {"registry": REGISTRY} if PROMETHEUS_AVAILABLE else {}

# ---- metric inventory (family-complete vs metrics.py:103-436) ----

# system / process health (:103-156)
system_up = Gauge("qt_system_up", "1 when the trading system is running", **_KW)
system_errors = Counter("qt_system_errors_total", "Unhandled errors", ["component"], **_KW)
component_status = Gauge("qt_component_status", "Per-component health (1 up / 0 down)", ["component"], **_KW)
cpu_usage_percent = Gauge("qt_cpu_usage_percent", "Process CPU usage percent", **_KW)
memory_usage_bytes = Gauge("qt_memory_usage_bytes", "Process resident memory", **_KW)
disk_usage_percent = Gauge("qt_disk_usage_percent", "Data-volume disk usage percent", **_KW)
process_uptime_seconds = Gauge("qt_process_uptime_seconds", "Seconds since process start", **_KW)
thread_count = Gauge("qt_thread_count", "Live thread count", **_KW)
memory_usage_percent = Gauge("qt_memory_usage_percent", "Process memory percent of system total", **_KW)
open_file_descriptors = Gauge("qt_open_file_descriptors", "Open file descriptors", **_KW)

# order lifecycle (:159-193)
orders_total = Counter("qt_orders_total", "All order events by terminal status", ["status"], **_KW)
orders_submitted = Counter("qt_orders_submitted_total", "Orders submitted", ["symbol", "side"], **_KW)
orders_filled = Counter("qt_orders_filled_total", "Orders filled", ["symbol"], **_KW)
orders_rejected = Counter("qt_orders_rejected_total", "Orders rejected", ["reason"], **_KW)
orders_cancelled = Counter("qt_orders_cancelled_total", "Orders cancelled", ["symbol"], **_KW)
order_value_total = Counter("qt_order_value_total", "Notional value of filled orders", ["symbol", "side"], **_KW)

# PnL / positions (:197-237)
portfolio_value = Gauge("qt_portfolio_value", "Total portfolio value", **_KW)
daily_pnl = Gauge("qt_daily_pnl", "Daily PnL", **_KW)
realized_pnl = Gauge("qt_realized_pnl", "Realized PnL", **_KW)
unrealized_pnl = Gauge("qt_unrealized_pnl", "Unrealized PnL", **_KW)
cumulative_pnl = Gauge("qt_cumulative_pnl", "Cumulative PnL since inception", **_KW)
open_positions = Gauge("qt_open_positions", "Number of open positions", **_KW)
gross_exposure = Gauge("qt_gross_exposure", "Gross exposure", **_KW)
position_size = Gauge("qt_position_size", "Per-symbol position size", ["symbol"], **_KW)

# signals (:241-261)
signals_generated = Counter("qt_signals_generated_total", "Signals generated", ["strategy", "signal_type"], **_KW)
signals_acted_on = Counter("qt_signals_acted_on_total", "Signals converted to orders", ["strategy"], **_KW)
signal_strength = Gauge("qt_signal_strength", "Latest signal strength", ["strategy", "symbol"], **_KW)

# risk (:265-331)
var_95 = Gauge("qt_var_95", "Portfolio 95% VaR", **_KW)
portfolio_delta = Gauge("qt_portfolio_delta", "Aggregate delta", **_KW)
portfolio_gamma = Gauge("qt_portfolio_gamma", "Aggregate gamma", **_KW)
portfolio_vega = Gauge("qt_portfolio_vega", "Aggregate vega", **_KW)
portfolio_theta = Gauge("qt_portfolio_theta", "Aggregate theta", **_KW)
current_drawdown = Gauge("qt_current_drawdown", "Drawdown from peak", **_KW)
max_drawdown = Gauge("qt_max_drawdown", "Maximum drawdown to date", **_KW)
sharpe_ratio = Gauge("qt_sharpe_ratio", "Rolling Sharpe ratio", **_KW)
portfolio_volatility = Gauge("qt_portfolio_volatility", "Annualized portfolio volatility", **_KW)
position_concentration = Gauge("qt_position_concentration", "Largest position / gross exposure", **_KW)

# latency (:336-385)
signal_latency = Histogram("qt_signal_latency_seconds", "Signal generation latency", **_KW)
order_latency = Histogram("qt_order_latency_seconds", "Order submission latency", **_KW)
order_fill_latency = Histogram("qt_order_fill_latency_seconds", "Submit-to-fill latency", ["symbol"], **_KW)
fill_latency_by_venue = Histogram("qt_fill_latency_by_venue_seconds", "Submit-to-fill latency per venue", ["venue"], **_KW)
calibration_latency = Histogram("qt_calibration_latency_seconds", "Calibration wall time", ["model"], **_KW)
data_ingestion_latency = Histogram("qt_data_ingestion_latency_seconds", "Ingestion latency", **_KW)
api_latency = Histogram("qt_api_latency_seconds", "Data-service request latency", ["route"], **_KW)

# data quality (:389-417) — per-provider breakdowns
data_quality_errors = Counter("qt_data_quality_errors_total", "Validation errors", ["check"], **_KW)
data_gaps_detected = Counter("qt_data_gaps_detected_total", "Gaps found in bar series", ["symbol", "provider"], **_KW)
data_validation_failures = Counter("qt_data_validation_failures_total", "Validation failures by provider", ["provider", "check"], **_KW)
data_age_seconds = Gauge("qt_data_age_seconds", "Age of the freshest record", ["symbol", "provider"], **_KW)
data_completeness_percent = Gauge("qt_data_completeness_percent", "Received/expected records", ["symbol", "provider"], **_KW)
provider_requests = Counter("qt_provider_requests_total", "Provider fetches by outcome", ["provider", "status"], **_KW)
provider_latency = Histogram("qt_provider_latency_seconds", "Provider fetch latency", ["provider"], **_KW)

# model / calibration (:422-440)
calibration_rmse = Gauge("qt_calibration_rmse", "Latest calibration RMSE", ["model", "underlying"], **_KW)
model_parameter = Gauge("qt_model_parameter", "Calibrated parameter value", ["model", "underlying", "parameter"], **_KW)
model_prediction_error = Histogram("qt_model_prediction_error", "Model vs market relative price error", ["model"], **_KW)

_METRICS: Dict[str, object] = {
    name: obj
    for name, obj in list(globals().items())
    if name not in ("REGISTRY",) and obj.__class__.__name__ in ("Counter", "Gauge", "Histogram", "_MockMetric")
}


def get_metric(name: str):
    return _METRICS.get(name)


def track_latency(histogram) -> Callable:
    """Context decorator recording wall time (metrics.py:448-497)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                histogram.observe(time.perf_counter() - t0)

        return inner

    return wrap


def count_calls(counter, **labels) -> Callable:
    """Call counter decorator (metrics.py:498-525)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            (counter.labels(**labels) if labels else counter).inc()
            return fn(*args, **kwargs)

        return inner

    return wrap


class MetricsCollector:
    """Background gauge refresher (metrics.py:527-620): polls registered
    callables and pushes their values into gauges."""

    def __init__(self, interval: float = 15.0):
        self.interval = interval
        self._sources: Dict[object, Callable[[], float]] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def register(self, gauge, source: Callable[[], float]) -> None:
        self._sources[gauge] = source

    def collect_once(self) -> None:
        for gauge, source in self._sources.items():
            try:
                gauge.set(float(source()))
            except Exception:  # noqa: BLE001 - a bad source must not kill collection
                system_errors.labels(component="metrics_collector").inc()

    def start(self) -> None:
        self._running = True

        def loop():
            while self._running:
                self.collect_once()
                time.sleep(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=2.0)


def register_system_sources(collector: MetricsCollector,
                            data_path: str = "/") -> None:
    """Wire the process/system gauges to stdlib sources (the reference
    feeds these from psutil, metrics.py:527-620; /proc + resource + os
    cover the same readings without the dependency)."""
    import os
    import resource

    start = time.time()
    page = os.sysconf("SC_PAGESIZE")

    def rss_bytes() -> float:
        with open("/proc/self/statm") as f:
            return float(f.read().split()[1]) * page

    def mem_percent() -> float:
        total = os.sysconf("SC_PHYS_PAGES") * page
        return 100.0 * rss_bytes() / total if total else 0.0

    def cpu_percent() -> float:
        # cumulative CPU time / wall time since start — a stable
        # utilisation proxy without a sampling interval
        ru = resource.getrusage(resource.RUSAGE_SELF)
        wall = max(time.time() - start, 1e-9)
        return 100.0 * (ru.ru_utime + ru.ru_stime) / wall

    def fd_count() -> float:
        try:
            return float(len(os.listdir("/proc/self/fd")))
        except OSError:
            return 0.0

    def disk_percent() -> float:
        st = os.statvfs(data_path)
        total = st.f_blocks * st.f_frsize
        free = st.f_bavail * st.f_frsize
        return 100.0 * (1.0 - free / total) if total else 0.0

    collector.register(cpu_usage_percent, cpu_percent)
    collector.register(memory_usage_bytes, rss_bytes)
    collector.register(memory_usage_percent, mem_percent)
    collector.register(open_file_descriptors, fd_count)
    collector.register(disk_usage_percent, disk_percent)
    collector.register(process_uptime_seconds, lambda: time.time() - start)
    collector.register(thread_count,
                       lambda: float(threading.active_count()))
