"""The port's service loops (``pde_tpu_torch/services.py``) held against
``pde_tpu.services`` on the CPU.

Mirrors ``tests/test_services.py``: the loop's iteration, failure and stop
semantics, and every service step on the simulated provider (seed 3), each
package against its own temporary sqlite file.  The port's steps run in
float64 on the CPU (``device="cpu"``); their statuses must equal the
reference's, and so must what they store: the ingested bars (closes at
1e-12), the mean-reversion candidates (the OU fit's ``mu``, half-life and
confidence at 1e-6, the OU fitters' own parity gate being 1e-8 on the
parameters).  The daily calibration (the reference marks it slow; one
symbol here, ~8 s for the port and ~11 s for the reference on this
machine's CPU) ends in the reference's status.  ``main`` takes ``--device``
before the service name and, with none, asks for the card.
"""

import numpy as np
import pytest
import torch

from pde_tpu import services as jsvc
from pde_tpu.data.providers import SimulatedDataProvider as JProvider
from pde_tpu.database.db import TimeSeriesDB as JDB
from pde_tpu_torch import services
from pde_tpu_torch.data.providers import SimulatedDataProvider
from pde_tpu_torch.database.db import TimeSeriesDB

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


@pytest.fixture
def dbs(tmp_path):
    return TimeSeriesDB(str(tmp_path / "port.db")), JDB(str(tmp_path / "reference.db"))


@pytest.fixture
def providers():
    return SimulatedDataProvider(seed=3, **CPU), JProvider(seed=3)


class TestServiceLoop:
    def test_runs_n_iterations_and_stops(self):
        calls = []
        loop = services.ServiceLoop("t", lambda: calls.append(1), interval_s=0.0,
                                    max_iterations=3)
        assert loop.run() == 0
        assert len(calls) == 3

    def test_survives_step_failures(self):
        state = {"n": 0}

        def flaky():
            state["n"] += 1
            if state["n"] == 1:
                raise RuntimeError("boom")
            return "ok"

        loop = services.ServiceLoop("t", flaky, interval_s=0.0, max_iterations=3)
        assert loop.run() == 0
        assert loop.failures == 1
        assert loop.iterations == 3

    def test_every_iteration_failing_exits_1(self):
        def boom():
            raise RuntimeError("boom")

        port = services.ServiceLoop("t", boom, interval_s=0.0, max_iterations=2)
        ref = jsvc.ServiceLoop("t", boom, interval_s=0.0, max_iterations=2)
        assert port.run() == ref.run() == 1

    def test_stop_breaks_sleep(self):
        loop = services.ServiceLoop("t", lambda: None, interval_s=60.0, max_iterations=5)
        orig = loop.step
        loop.step = lambda: (loop.stop(), orig())
        assert loop.run() == 0
        assert loop.iterations == 1


class TestSteps:
    def test_ingestion_step_stores_the_reference_s_bars(self, providers, dbs):
        out = services.ingestion_step(provider=providers[0], db=dbs[0], symbols=["SPY"], **CPU)
        ref = jsvc.ingestion_step(provider=providers[1], db=dbs[1], symbols=["SPY"])
        assert out == ref and out["SPY"] in ("SUCCESS", "PARTIAL")
        rows, ref_rows = (db.query_market_prices("SPY") for db in dbs)
        assert len(rows) == len(ref_rows) > 100
        np.testing.assert_allclose([r["close"] for r in rows], [r["close"] for r in ref_rows],
                                   rtol=1e-12)

    def test_signals_step_persists_the_reference_s_candidates(self, providers, dbs):
        syms = ["SPY", "QQQ", "IWM"]
        out = services.signals_step(provider=providers[0], db=dbs[0], symbols=syms, **CPU)
        ref = jsvc.signals_step(provider=providers[1], db=dbs[1], symbols=syms)
        assert out == ref
        assert "candidate" in out.values()
        for sym in syms:
            got, want = (db.query_signals(asset=sym) for db in dbs)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert (g["strategy"], g["signal_type"]) == (w["strategy"], w["signal_type"])
                np.testing.assert_allclose(g["confidence"], w["confidence"], rtol=1e-6)
                for k in ("mu", "half_life_days"):
                    np.testing.assert_allclose(g["payload"][k], w["payload"][k], rtol=1e-6)

    def test_calibration_step_runs_orchestrator(self, providers, dbs):
        out = services.calibration_step(provider=providers[0], db=dbs[0], symbols=["SPY"],
                                        **CPU)
        ref = jsvc.calibration_step(provider=providers[1], db=dbs[1], symbols=["SPY"])
        assert out == ref
        assert out["SPY"] in ("SUCCESS", "PARTIAL", "FAILED")

    def test_execution_step_trades_a_session(self, monkeypatch, tmp_path):
        monkeypatch.chdir(tmp_path)  # the trading systems' default sqlite files
        monkeypatch.setenv("PDE_SYMBOLS", "SPY")
        out = services.execution_step(symbols=["SPY"], n_ticks=40, **CPU)
        ref = jsvc.execution_step(symbols=["SPY"], n_ticks=40)
        assert "orders_submitted" in out
        assert out["orders_submitted"] == ref["orders_submitted"]

    def test_chain_rows_map_as_the_reference_s(self, providers):
        chain = providers[1].get_options_chain("SPY")
        got = services._chain_to_market_options(chain, 100.0)
        want = jsvc._chain_to_market_options(chain, 100.0)
        for k in ("strike", "maturity", "mid_price"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["option_type"] == want["option_type"]


class TestMain:
    def test_main_rejects_unknown_service(self):
        assert services.main(["nope"]) == 2
        assert services.main([]) == 2
        assert services.main(["--device", "cpu"]) == 2
        assert services.main(["--device", "cpu", "nope"]) == 2

    def test_main_runs_bounded_loop(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PDE_SERVICE_MAX_ITERATIONS", "1")
        monkeypatch.setenv("PDE_SERVICE_INTERVAL_S", "0")
        monkeypatch.setenv("PDE_SYMBOLS", "SPY")
        monkeypatch.setenv("PDE_DB_PATH", str(tmp_path / "svc.db"))
        assert services.main(["--device", "cpu", "data-ingestion"]) == 0
        assert len(TimeSeriesDB(str(tmp_path / "svc.db")).query_market_prices("SPY")) > 100
        assert services.main(["--device", "cpu", "signals"]) == 0

    def test_main_asks_for_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setenv("PDE_SERVICE_MAX_ITERATIONS", "1")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            services.main(["data-ingestion"])
