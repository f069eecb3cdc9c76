"""The port's copies of ``pde_tpu``'s host-side modules stay copies.

The port may not import ``pde_tpu`` (its ``__init__`` imports JAX), so it
carries its own copies of the pure-Python modules its paths need.  Each
copy's syntax tree must equal its reference file's once three things are
set aside: docstrings, import statements, and the package's own name in
string constants (``"pde_tpu_torch"`` reads as ``"pde_tpu"``: the logger
names, the database client's application name).  Every other difference
is listed below, function by function, with its reason.  The test reads
the two source files only; it imports neither.  (Relative imports read
the port's own modules: ``execution/algorithms.simulate_fills`` imports
the port's ``native``, whose library is built from the same C++ sources.)
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "takes the device and dtype its numerics run on"
INTERVAL = ("binds its interval as CAST(? AS interval): the reference's INTERVAL ? is "
            "INTERVAL $2 on the wire, which PostgreSQL refuses to parse")
CLEARTEXT = ("sends a cleartext password only to a loopback host or with allow_cleartext: "
             "the client has no TLS, and the reference sends it to any host")

# path -> {function or class member that differs: why}
COPIES = {
    "backtest/events.py": {},
    "backtest/metrics.py": {},
    "backtest/strategy.py": {},
    "backtest/execution.py": {},
    "backtest/portfolio.py": {},
    "backtest/engine.py": {},
    "backtest/sectors.py": {},
    "core/config.py": {},
    "monitoring/logging.py": {},
    "monitoring/metrics.py": {},
    "signals/mean_reversion.py": {},
    "signals/aggregator.py": {},
    "risk/drawdown_controller.py": {},
    "risk/risk_manager.py": {
        "RiskManager.__init__": DEVICE,
        "RiskManager.compute_portfolio_risk": "hands its device and dtype to the VaR",
    },
    "data/reference.py": {},
    "data/streaming.py": {},
    "execution/order.py": {},
    "execution/broker.py": {},
    "execution/order_manager.py": {},
    "execution/emergency.py": {},
    "database/db.py": {},
    "database/pgwire.py": {
        "parse_pg_url": "reads allow_cleartext from the URL's query",
        "_is_loopback": "new: whether a host names this machine, without resolving it",
        "PgConnection.__init__": CLEARTEXT + "; closes its socket when the startup fails",
        "PgConnection._auth_loop": CLEARTEXT,
    },
    "data/validation.py": {},
    "data/ingestion.py": {},
    "monitoring/alerts.py": {},
    # the rest of the reference's host-side modules
    "execution/algorithms.py": {},  # simulate_fills' `from .. import native` is the port's
    "execution/tca.py": {},
    "execution/routing.py": {},
    "execution/reconciliation.py": {},
    "risk/greeks_monitor.py": {},
    "risk/correlation_monitor.py": {},
    "validation/model_validation.py": {},
    "validation/walk_forward.py": {},
    "validation/benchmarks.py": {},
    "monitoring/attribution.py": {},
    "monitoring/diagnostics.py": {},
    "monitoring/dashboards.py": {},
    "monitoring/runbooks.py": {},
    "data/request_schema.py": {},
    "data/monitoring.py": {},
    "data/recovery.py": {},
    "data/storage.py": {},
    "data/alternative.py": {},
    "data/api.py": {},
    "database/migrations.py": {},
    "database/timescale.py": {
        "_check_columns": "new: segment_by's column names against the identifier pattern",
        "TimescaleManager.enable_compression": (
            INTERVAL + "; checks segment_by's column names before any statement, where the "
            "reference writes the string into its DDL unchecked"),
        "TimescaleManager.add_retention_policy": INTERVAL,
    },
    # the ported modules that keep the reference's code around one change
    "data/providers.py": {
        "SimulatedDataProvider.__init__": DEVICE,
        "SimulatedDataProvider.get_options_chain":
            "prices the chain by the port's Black-Scholes on the provider's device",
    },
    "signals/variance_premium.py": {
        "VariancePremiumStrategy.__init__": DEVICE,
        "VariancePremiumStrategy._tensor": "puts host numbers on that device (new)",
        "VariancePremiumStrategy.expected_variance": "the maturity as a tensor there",
        "VariancePremiumStrategy.evaluate_chain": "the strip's strikes and prices there",
    },
    "monitoring/health.py": {
        "SyntheticCalibrationProbe.__init__": DEVICE,
        "SyntheticCalibrationProbe._check": "fits on that device in that dtype",
    },
    "services.py": {
        "_provider": "the simulated provider prices on the service's device",
        "calibration_step": "hands the service's device and dtype to the orchestrator",
        "signals_step": "hands them to the OU fitter",
        "ingestion_step": "hands them to the provider",
        "execution_step": "hands them to the trading system",
        "main": "takes --device before the service name; the card when absent",
    },
    "trading_system.py": {
        "TradingSystem.__init__": DEVICE,
        "TradingSystem.initialize": "hands them to the calibrators, signals and VaR",
        "TradingSystem._build_risk_manager": "hands them to the risk manager",
        "TradingSystem.run_monte_carlo": "hands the device to the Monte Carlo",
        "TradingSystem.run_live": "hands the device to the vote; no TPU keep-alive thread",
        "create_trading_system": DEVICE,
    },
}


class _Normalize(ast.NodeTransformer):
    """Drop docstrings and imports; read the port's name as the reference's."""

    def _body(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = _body

    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = node.value.replace("pde_tpu_torch", "pde_tpu")
        return node


def _units(path):
    """Each top-level function, class member and the rest, as AST dumps."""
    with open(path) as f:
        tree = _Normalize().visit(ast.parse(f.read()))
    units, rest = {}, []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            units[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            members = []
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    units[f"{node.name}.{item.name}"] = ast.dump(item)
                else:
                    members.append(ast.dump(item))
            units[node.name] = (ast.dump(ast.ClassDef(
                node.name, node.bases, node.keywords, [], node.decorator_list,
                getattr(node, "type_params", []))), members)
        else:
            rest.append(ast.dump(node))
    units["<module>"] = rest
    return units


@pytest.mark.parametrize("path", list(COPIES))
def test_copy_equals_the_reference(path):
    ref = _units(os.path.join(ROOT, "pde_tpu", path))
    port = _units(os.path.join(ROOT, "pde_tpu_torch", path))
    differ = {k for k in ref.keys() | port.keys() if ref.get(k) != port.get(k)}
    assert differ == set(COPIES[path]), sorted(differ ^ set(COPIES[path]))


def test_every_copied_module_is_listed():
    """A module of the port that is the reference file under its own path
    but for docstrings and imports must be listed above."""
    unlisted = []
    for base, _, files in os.walk(os.path.join(ROOT, "pde_tpu_torch")):
        for name in files:
            rel = os.path.relpath(os.path.join(base, name), os.path.join(ROOT, "pde_tpu_torch"))
            ref = os.path.join(ROOT, "pde_tpu", rel)
            if (name.endswith(".py") and name != "__init__.py" and rel not in COPIES
                    and os.path.exists(ref)
                    and _units(ref) == _units(os.path.join(ROOT, "pde_tpu_torch", rel))):
                unlisted.append(rel)
    assert not unlisted


def test_timescale_binds_its_intervals_as_a_cast():
    """The reference's ``INTERVAL ?`` reaches PostgreSQL as ``INTERVAL $2``,
    a parse error; the port's copy sends ``CAST($2 AS interval)``.  Both
    managers run against a recording stand-in for the server engine, whose
    statements go through the port's own ``?`` -> ``$n`` translation."""
    from pde_tpu.database.timescale import TimescaleManager as JManager
    from pde_tpu_torch.database.db import _PostgresEngine
    from pde_tpu_torch.database.timescale import TimescaleManager

    class Server:
        engine_name, is_timescale = "postgresql", True

        def __init__(self):
            self.sent = []

        def run_execute(self, sql, params=()):
            self.sent.append((_PostgresEngine._translate(None, sql), tuple(params)))

        run_script = run_execute

    def policies(manager_cls):
        server = Server()
        mgr = manager_cls(server)
        mgr.enable_compression("market_prices", compress_after="7 days")
        mgr.add_retention_policy("market_prices", drop_after="30 days")
        return [sql for sql, _ in server.sent if "policy" in sql], server.sent

    port, sent = policies(TimescaleManager)
    ref, _ = policies(JManager)
    assert port == ["SELECT add_compression_policy($1, CAST($2 AS interval), "
                    "if_not_exists => TRUE)",
                    "SELECT add_retention_policy($1, CAST($2 AS interval), "
                    "if_not_exists => TRUE)"]
    assert all("INTERVAL $2" in sql for sql in ref)
    assert ("market_prices", "7 days") in [p for _, p in sent]
    assert ("market_prices", "30 days") in [p for _, p in sent]
