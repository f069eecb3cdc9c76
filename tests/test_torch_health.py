"""The port's health manager and alerts (``pde_tpu_torch/monitoring``)
held against ``pde_tpu.monitoring`` on the CPU.

Mirrors the health and alert cases of ``tests/test_monitoring.py``, each
check run through both packages where it has no side effect, with equal
states: the manager's aggregation and k8s views, the database, disk,
memory and CPU checks, the circuit breaker, the TCP, HTTP, Redis and
RabbitMQ checks against local servers and a closed local port (no test
leaves this host), and the three synthetic probes.  The calibration probe
fits its SABR smile on the device it is given (float64 on the CPU here),
within the reference's 1e-3 RMSE, and with no device and no card it is
unhealthy, not quietly run on the CPU.  The package exports
``AlertManager`` and ``HealthManager`` as the reference's does.
"""

from datetime import timedelta

import pytest
import torch

from pde_tpu.monitoring import alerts as jal
from pde_tpu.monitoring import health as jhl
from pde_tpu_torch import monitoring
from pde_tpu_torch.database.db import TimeSeriesDB
from pde_tpu_torch.monitoring import alerts as al
from pde_tpu_torch.monitoring import health as hl

CPU = dict(device="cpu", dtype=torch.float64)


def test_the_package_exports_the_reference_s_managers():
    assert monitoring.AlertManager is al.AlertManager
    assert monitoring.HealthManager is hl.HealthManager
    assert set(hl.__all__) == set(jhl.__all__)


@pytest.mark.parametrize("mod", [hl, jhl], ids=["port", "reference"])
def test_manager_aggregation(mod):
    mgr = mod.HealthManager()
    mgr.register(mod.CallableCheck("good", lambda: True))
    mgr.register(mod.CallableCheck("bad_noncritical", lambda: (False, "meh"), critical=False))
    mgr.run_all()
    assert mgr.overall == mod.HealthState.DEGRADED
    mgr.register(mod.CallableCheck("bad_critical", lambda: False))
    mgr.run_all()
    assert mgr.overall == mod.HealthState.UNHEALTHY
    ready = mgr.readiness()
    assert ready["status"] == "fail" and ready["state"] == "unhealthy"
    assert mgr.liveness()["status"] == "ok"


def test_database_check(tmp_path):
    res = hl.DatabaseCheck(TimeSeriesDB(str(tmp_path / "health.db"))).run()
    assert res.state == hl.HealthState.HEALTHY


def test_disk_memory_and_cpu_checks(monkeypatch):
    assert hl.DiskCheck(min_free_pct=0.0).run().state == hl.HealthState.HEALTHY
    assert hl.MemoryCheck(max_rss_mb=1e9).run().state == hl.HealthState.HEALTHY
    assert hl.CPUCheck(max_load_per_core=1e9).run().state == hl.HealthState.HEALTHY
    monkeypatch.setattr(hl.os, "getloadavg", lambda: (64.0, 64.0, 64.0))
    assert hl.CPUCheck(max_load_per_core=0.5).run().state == hl.HealthState.DEGRADED


def test_circuit_breaker():
    cb = hl.CircuitBreaker(failure_threshold=2, recovery_seconds=100.0)

    def boom():
        raise RuntimeError("x")

    for _ in range(2):
        with pytest.raises(RuntimeError):
            cb.call(boom)
    assert cb.state == "open"
    with pytest.raises(hl.CircuitBreakerOpen):
        cb.call(lambda: 1)


@pytest.mark.parametrize("mod", [hl, jhl], ids=["port", "reference"])
def test_unreachable_local_ports(mod):
    assert mod.TCPCheck("nowhere", "127.0.0.1", 1, timeout=0.2).run().state == \
        mod.HealthState.UNHEALTHY
    assert mod.RabbitMQCheck("127.0.0.1", 1, timeout=0.2).run().state == \
        mod.HealthState.UNHEALTHY
    assert mod.RedisCheck("127.0.0.1", 1, timeout=0.2).run().state == \
        mod.HealthState.UNHEALTHY
    assert mod.HTTPCheck("api", "http://127.0.0.1:1/x", timeout=0.2).run().state == \
        mod.HealthState.UNHEALTHY


def test_http_check_against_a_local_server():
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200 if self.path == "/health" else 503)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        for mod in (hl, jhl):
            assert mod.HTTPCheck("api", f"{base}/health").run().state == mod.HealthState.HEALTHY
            assert mod.HTTPCheck("api", f"{base}/bad").run().state == mod.HealthState.DEGRADED
    finally:
        srv.shutdown()


def test_redis_check_protocol():
    import socketserver
    import threading

    class FakeRedis(socketserver.StreamRequestHandler):
        def handle(self):
            if b"PING" in self.rfile.readline():
                self.wfile.write(b"+PONG\r\n")

    srv = socketserver.TCPServer(("127.0.0.1", 0), FakeRedis)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        res = hl.RedisCheck("127.0.0.1", srv.server_address[1]).run()
        assert res.state == hl.HealthState.HEALTHY
    finally:
        srv.shutdown()


def test_synthetic_calibration_probe_fits_on_its_device():
    res = hl.SyntheticCalibrationProbe(**CPU).run()
    ref = jhl.SyntheticCalibrationProbe().run()
    assert res.state == ref.state == hl.HealthState.HEALTHY, res.message
    rmse, ref_rmse = (float(r.message.split()[-1]) for r in (res, ref))
    assert rmse <= 1e-3 and ref_rmse <= 1e-3


def test_synthetic_calibration_probe_without_a_card_is_unhealthy(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = hl.SyntheticCalibrationProbe().run()
    assert res.state == hl.HealthState.UNHEALTHY
    assert "no CUDA device" in res.message


@pytest.mark.parametrize("probe", ["SyntheticOrderFlowProbe", "SyntheticDataFeedProbe"])
def test_synthetic_probes_as_the_reference_s(probe):
    res, ref = getattr(hl, probe)().run(), getattr(jhl, probe)().run()
    assert res.state == ref.state == hl.HealthState.HEALTHY, res.message


def test_manager_with_the_three_synthetic_probes():
    mgr = hl.HealthManager()
    for check in (hl.SyntheticOrderFlowProbe(), hl.SyntheticDataFeedProbe(),
                  hl.SyntheticCalibrationProbe(**CPU)):
        mgr.register(check)
    ready = mgr.readiness()
    assert mgr.overall == hl.HealthState.HEALTHY
    assert ready["status"] == "ok"
    assert set(ready["checks"]) == {"synthetic_order_flow", "synthetic_data_feed",
                                    "synthetic_calibration"}


@pytest.mark.parametrize("mod", [al, jal], ids=["port", "reference"])
def test_alert_rules_dedup_and_escalation(mod):
    sent = []
    mgr = mod.AlertManager(channels=[mod.LogChannel(sink=sent.append)],
                           dedup_window=timedelta(minutes=5))
    for rule in mod.default_rules():
        mgr.add_rule(rule)
    fired = mgr.evaluate_rules({"current_drawdown": 0.30, "daily_pnl_pct": 0.01})
    assert {"high_drawdown", "critical_drawdown"} <= {a.title for a in fired}
    n = len(sent)
    mgr.evaluate_rules({"current_drawdown": 0.30})
    assert len(sent) == n
    esc = mod.AlertManager(channels=[mod.LogChannel(sink=lambda m: None)],
                           dedup_window=timedelta(hours=1), escalation_after=2)
    for _ in range(2):
        esc.fire(mod.Alert("thing", "msg", mod.AlertSeverity.WARNING, source="m"))
    escalated = mod.Alert("thing", "msg", mod.AlertSeverity.WARNING, source="m")
    assert esc.fire(escalated)
    assert escalated.severity == mod.AlertSeverity.ERROR
