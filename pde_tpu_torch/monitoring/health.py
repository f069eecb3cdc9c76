"""Health checks, synthetic probes, circuit breaker, liveness/readiness.

Twin of ``pde_tpu/monitoring/health.py``: the reference's code but for
one change.  Its probes reach the port's own modules (the copied
``execution`` and ``data.streaming``, the ported ``calibrate.sabr``), and
the calibration probe fits on the device it is given (``device=None``:
the card, through ``core/precision.default_device``; never a quiet CPU
run) in the dtype it is given (torch's default float when None).

Mirrors the reference monitoring/health.py: the pluggable HealthCheck
framework (DB/TCP/HTTP/memory/disk/CPU, :99-506), synthetic end-to-end
probes (order-flow / data-feed / calibration, :542-732), the CircuitBreaker
(:759-835) and the HealthManager with k8s liveness/readiness views
(:836-1057).
"""

from __future__ import annotations

import abc
import enum
import os
import shutil
import socket
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Callable, Dict, List, Optional

__all__ = [
    "HealthState",
    "HealthCheckResult",
    "HealthCheck",
    "CallableCheck",
    "DatabaseCheck",
    "TCPCheck",
    "HTTPCheck",
    "RedisCheck",
    "RabbitMQCheck",
    "MemoryCheck",
    "DiskCheck",
    "CPUCheck",
    "SyntheticCalibrationProbe",
    "SyntheticOrderFlowProbe",
    "SyntheticDataFeedProbe",
    "CircuitBreaker",
    "CircuitBreakerOpen",
    "HealthManager",
]


class HealthState(str, enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    UNHEALTHY = "unhealthy"


@dataclass
class HealthCheckResult:
    name: str
    state: HealthState
    message: str = ""
    latency_ms: float = 0.0
    critical: bool = True
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))


class HealthCheck(abc.ABC):
    def __init__(self, name: str, critical: bool = True):
        self.name = name
        self.critical = critical

    @abc.abstractmethod
    def _check(self) -> tuple:
        """Returns (state, message)."""

    def run(self) -> HealthCheckResult:
        t0 = time.perf_counter()
        try:
            state, message = self._check()
        except Exception as exc:  # noqa: BLE001
            state, message = HealthState.UNHEALTHY, f"check raised: {exc}"
        return HealthCheckResult(
            name=self.name, state=state, message=message,
            latency_ms=(time.perf_counter() - t0) * 1000.0, critical=self.critical,
        )


class CallableCheck(HealthCheck):
    """Wrap any () -> bool | (bool, msg) callable."""

    def __init__(self, name: str, fn: Callable, critical: bool = True):
        super().__init__(name, critical)
        self.fn = fn

    def _check(self):
        out = self.fn()
        if isinstance(out, tuple):
            ok, msg = out
        else:
            ok, msg = bool(out), ""
        return (HealthState.HEALTHY if ok else HealthState.UNHEALTHY), msg


class DatabaseCheck(HealthCheck):
    """TimeSeriesDB liveness (health.py:99-160)."""

    def __init__(self, db, critical: bool = True):
        super().__init__("database", critical)
        self.db = db

    def _check(self):
        out = self.db.health_check()
        if out.get("healthy"):
            return HealthState.HEALTHY, f"latency {out.get('latency_ms', 0):.1f} ms"
        return HealthState.UNHEALTHY, out.get("error", "unknown")


class TCPCheck(HealthCheck):
    """Socket reachability (health.py:161-220)."""

    def __init__(self, name: str, host: str, port: int, timeout: float = 2.0, critical: bool = True):
        super().__init__(name, critical)
        self.host, self.port, self.timeout = host, port, timeout

    def _check(self):
        try:
            with socket.create_connection((self.host, self.port), timeout=self.timeout):
                return HealthState.HEALTHY, f"{self.host}:{self.port} reachable"
        except OSError as exc:
            return HealthState.UNHEALTHY, str(exc)


class HTTPCheck(HealthCheck):
    """HTTP endpoint reachability + status code (health.py:221-290).

    Uses stdlib urllib; any status in ``ok_statuses`` is healthy, other
    statuses are degraded (the endpoint answered), connection failures are
    unhealthy.
    """

    def __init__(self, name: str, url: str, timeout: float = 3.0,
                 ok_statuses: tuple = (200,), critical: bool = True):
        super().__init__(name, critical)
        self.url, self.timeout, self.ok_statuses = url, timeout, tuple(ok_statuses)

    def _check(self):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.url, timeout=self.timeout) as resp:
                code = resp.status
        except urllib.error.HTTPError as exc:
            code = exc.code
        except (urllib.error.URLError, OSError) as exc:
            return HealthState.UNHEALTHY, f"{self.url}: {exc}"
        if code in self.ok_statuses:
            return HealthState.HEALTHY, f"{self.url} -> {code}"
        return HealthState.DEGRADED, f"{self.url} -> {code}"


class RedisCheck(HealthCheck):
    """Redis liveness via an in-protocol PING (health.py:291-340).

    Speaks RESP directly over a socket (no redis-py dependency): sends
    ``PING\\r\\n`` and requires ``+PONG``.
    """

    def __init__(self, host: str = "localhost", port: int = 6379,
                 timeout: float = 2.0, critical: bool = False):
        super().__init__("redis", critical)
        self.host, self.port, self.timeout = host, port, timeout

    def _check(self):
        try:
            with socket.create_connection((self.host, self.port), timeout=self.timeout) as s:
                s.settimeout(self.timeout)
                s.sendall(b"PING\r\n")
                reply = s.recv(64)
        except OSError as exc:
            return HealthState.UNHEALTHY, str(exc)
        if reply.startswith(b"+PONG"):
            return HealthState.HEALTHY, f"{self.host}:{self.port} PONG"
        return HealthState.DEGRADED, f"unexpected reply {reply[:16]!r}"


class RabbitMQCheck(HealthCheck):
    """RabbitMQ reachability via the AMQP protocol header (health.py:341-379).

    Sends the AMQP 0-9-1 protocol header and requires the broker to answer
    with a Connection.Start frame (type 1) rather than closing the socket.
    """

    def __init__(self, host: str = "localhost", port: int = 5672,
                 timeout: float = 2.0, critical: bool = False):
        super().__init__("rabbitmq", critical)
        self.host, self.port, self.timeout = host, port, timeout

    def _check(self):
        try:
            with socket.create_connection((self.host, self.port), timeout=self.timeout) as s:
                s.settimeout(self.timeout)
                s.sendall(b"AMQP\x00\x00\x09\x01")
                reply = s.recv(8)
        except OSError as exc:
            return HealthState.UNHEALTHY, str(exc)
        if reply[:1] == b"\x01":  # METHOD frame => Connection.Start
            return HealthState.HEALTHY, f"{self.host}:{self.port} AMQP handshake"
        return HealthState.DEGRADED, f"unexpected reply {reply!r}"


class MemoryCheck(HealthCheck):
    """Process RSS vs a soft limit (health.py:380-440)."""

    def __init__(self, max_rss_mb: float = 8192.0, critical: bool = False):
        super().__init__("memory", critical)
        self.max_rss_mb = max_rss_mb

    def _check(self):
        rss_mb = 0.0
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        rss_mb = float(line.split()[1]) / 1024.0
                        break
        except OSError:
            return HealthState.DEGRADED, "cannot read /proc/self/status"
        if rss_mb > self.max_rss_mb:
            return HealthState.DEGRADED, f"RSS {rss_mb:.0f} MB > {self.max_rss_mb:.0f} MB"
        return HealthState.HEALTHY, f"RSS {rss_mb:.0f} MB"


class DiskCheck(HealthCheck):
    """Free space on a path (health.py:441-506)."""

    def __init__(self, path: str = "/", min_free_pct: float = 0.05, critical: bool = False):
        super().__init__("disk", critical)
        self.path = path
        self.min_free_pct = min_free_pct

    def _check(self):
        usage = shutil.disk_usage(self.path)
        free_pct = usage.free / usage.total
        if free_pct < self.min_free_pct:
            return HealthState.DEGRADED, f"{free_pct:.1%} free on {self.path}"
        return HealthState.HEALTHY, f"{free_pct:.1%} free on {self.path}"


class CPUCheck(HealthCheck):
    """1-minute load average vs core count (health.py:460-506)."""

    def __init__(self, max_load_per_core: float = 2.0, critical: bool = False):
        super().__init__("cpu", critical)
        self.max_load_per_core = max_load_per_core

    def _check(self):
        load1, _, _ = os.getloadavg()
        cores = os.cpu_count() or 1
        per_core = load1 / cores
        if per_core > self.max_load_per_core:
            return HealthState.DEGRADED, f"load {load1:.1f} on {cores} cores"
        return HealthState.HEALTHY, f"load {load1:.1f} on {cores} cores"


class SyntheticOrderFlowProbe(HealthCheck):
    """End-to-end order-flow probe (health.py:542-610): submit a 1-share
    order to a throwaway simulated broker through the OrderManager and
    require a fill."""

    def __init__(self, critical: bool = False):
        super().__init__("synthetic_order_flow", critical)

    def _check(self):
        from ..execution import OrderManager, SimulatedBroker
        from ..execution.order import Order, OrderSide

        broker = SimulatedBroker(initial_cash=1_000.0)
        broker.connect()
        broker.set_price("__PROBE__", 1.0)
        om = OrderManager(broker=broker)
        order = Order(symbol="__PROBE__", side=OrderSide.BUY, quantity=1.0,
                      strategy_id="health_probe")
        om.submit_order(order, reference_price=1.0)
        if order.status.value.lower() == "filled":
            return HealthState.HEALTHY, f"round-trip fill @ {order.avg_fill_price:.4f}"
        return HealthState.UNHEALTHY, f"order ended {order.status.value}"


class SyntheticDataFeedProbe(HealthCheck):
    """End-to-end data-feed probe (health.py:611-671): pull ticks from a
    provider and require fresh, positive prices."""

    def __init__(self, provider=None, max_staleness_s: float = 60.0, critical: bool = False):
        super().__init__("synthetic_data_feed", critical)
        self.provider = provider
        self.max_staleness_s = max_staleness_s

    def _check(self):
        provider = self.provider
        if provider is None:
            from ..data.streaming import SimulatedStreamProvider

            provider = SimulatedStreamProvider(seed=0, base_prices={"__PROBE__": 100.0})
        ticks = provider.step(["__PROBE__"])
        if not ticks:
            return HealthState.UNHEALTHY, "provider returned no ticks"
        tick = ticks[-1]
        if tick.price <= 0:
            return HealthState.UNHEALTHY, f"non-positive price {tick.price}"
        age = (datetime.now(timezone.utc) - tick.time).total_seconds()
        if age > self.max_staleness_s:
            return HealthState.DEGRADED, f"tick {age:.0f}s stale"
        return HealthState.HEALTHY, f"tick {tick.price:.2f}, {age:.1f}s old"


class SyntheticCalibrationProbe(HealthCheck):
    """End-to-end calibration smoke probe (health.py:672-732): fit a tiny
    synthetic SABR smile and require sub-threshold RMSE."""

    def __init__(self, max_rmse: float = 1e-3, critical: bool = False, device=None,
                 dtype=None):
        super().__init__("synthetic_calibration", critical)
        self.max_rmse = max_rmse
        self.device = device
        self.dtype = dtype

    def _check(self):
        from ..calibrate.sabr import SABRCalibrator

        where = dict(device=self.device, dtype=self.dtype)
        strikes, vols = SABRCalibrator.generate_synthetic_smile(n_strikes=7, **where)
        _, rmse = SABRCalibrator(**where).calibrate_single_maturity(strikes, vols, F=100.0,
                                                                   T=0.5)
        if rmse <= self.max_rmse:
            return HealthState.HEALTHY, f"smile rmse {rmse:.2e}"
        return HealthState.UNHEALTHY, f"smile rmse {rmse:.2e} > {self.max_rmse:.0e}"


class CircuitBreakerOpen(Exception):
    pass


class CircuitBreaker:
    """Closed -> open after N failures; half-open retry after a cooldown
    (health.py:759-835)."""

    def __init__(self, failure_threshold: int = 5, recovery_seconds: float = 30.0, name: str = ""):
        self.failure_threshold = failure_threshold
        self.recovery_seconds = recovery_seconds
        self.name = name
        self._failures = 0
        self._opened_at: Optional[float] = None

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "closed"
        if time.monotonic() - self._opened_at >= self.recovery_seconds:
            return "half_open"
        return "open"

    def call(self, fn: Callable, *args, **kwargs):
        if self.state == "open":
            raise CircuitBreakerOpen(f"circuit '{self.name}' open")
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._opened_at = time.monotonic()
            raise
        self._failures = 0
        self._opened_at = None
        return out


class HealthManager:
    """Runs registered checks and answers k8s-style probes (health.py:836-1057)."""

    def __init__(self):
        self.checks: List[HealthCheck] = []
        self.last_results: Dict[str, HealthCheckResult] = {}

    def register(self, check: HealthCheck) -> None:
        self.checks.append(check)

    def run_all(self) -> Dict[str, HealthCheckResult]:
        self.last_results = {c.name: c.run() for c in self.checks}
        return self.last_results

    @property
    def overall(self) -> HealthState:
        results = self.last_results or self.run_all()
        states = list(results.values())
        if any(r.state == HealthState.UNHEALTHY and r.critical for r in states):
            return HealthState.UNHEALTHY
        if any(r.state != HealthState.HEALTHY for r in states):
            return HealthState.DEGRADED
        return HealthState.HEALTHY

    def liveness(self) -> Dict:
        """k8s liveness: process is up (health.py:1050-1057)."""
        return {"status": "ok", "pid": os.getpid()}

    def readiness(self) -> Dict:
        """k8s readiness: all critical checks pass."""
        self.run_all()
        state = self.overall
        return {
            "status": "ok" if state != HealthState.UNHEALTHY else "fail",
            "state": state.value,
            "checks": {
                name: {"state": r.state.value, "message": r.message, "critical": r.critical}
                for name, r in self.last_results.items()
            },
        }
