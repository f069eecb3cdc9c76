"""The port's command line against ``pde_tpu.cli``: the trading system and
the strategy searches.

Both packages run the argv of ``tests/test_system.py`` on the simulated
provider's bars (the port with ``--device cpu`` and torch's default dtype
float64, the reference under x64), each in a working folder of its own.
Gates:
- ``backtest``, ``scan``, ``sector-portfolio``, ``rolling-backtest`` and
  ``optimize-sectors``: equal output, the choices and every printed figure
  (the event engine and the sectors are plain copies; the OU fits and the
  strategy grids round to the printed digits identically), and
  ``optimize-sectors``' checkpoint files equal in their choices, their
  unrounded figures within 1e-12 relative (the grid's metrics reduce in
  another order, ``tests/test_torch_optimizer.py``);
- ``status``, ``portfolio`` and ``config``: the same JSON but the ``time``
  field; ``config --save`` writes the same file.
"""

import json

import pytest

from torch_cli_parity import Runs, assert_close

ARGV = {
    "backtest": ["backtest", "--symbols", "SPY", "--days", "200", "--json"],
    "status": ["status"],
    "portfolio": ["portfolio"],
    "config": ["config"],
    "config_save": ["config", "--save", "out.json"],
    "scan": ["scan", "--symbols", "AAA", "BBB", "--days", "300"],
    "sector_portfolio": ["sector-portfolio", "--symbols", "AAPL", "XOM", "--days", "200"],
    "rolling_backtest": ["rolling-backtest", "--symbol", "SPY", "--days", "320",
                         "--opt-window", "150", "--trade-window", "80",
                         "--strategies", "momentum"],
    "optimize_sectors": ["optimize-sectors", "--symbols", "AAPL", "--days", "300",
                         "--cache", "fits.json"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return Runs(ARGV, tmp_path_factory.mktemp("cli_trading"))


@pytest.mark.parametrize("name", ["backtest", "scan", "sector_portfolio", "rolling_backtest",
                                  "optimize_sectors"])
def test_output_equals_the_reference(runs, name):
    (ref_rc, ref), (port_rc, port) = runs[name]
    assert ref_rc == 0 and port_rc == 0
    assert port == ref


@pytest.mark.parametrize("name", ["status", "portfolio", "config"])
def test_json_equals_the_reference_but_the_time(runs, name):
    port, ref = runs.json(name)
    for out in (port, ref):
        out.pop("time", None)
    assert port == ref


def test_status_reports_every_component_initialised(runs):
    port, _ = runs.json("status")
    assert port["initialized"] and port["components"] and all(port["components"].values())


def _saved(runs, name, path):
    (ref_rc, _), (port_rc, _) = runs[name]
    assert ref_rc == 0 and port_rc == 0
    folder = f"{runs.workdir}/{name}"
    with open(f"{folder}/port/{path}") as f, open(f"{folder}/ref/{path}") as g:
        return json.load(f), json.load(g)


def test_saved_config_equals_the_reference(runs):
    port, ref = _saved(runs, "config_save", "out.json")
    assert port == ref


def test_optimizer_checkpoint_matches_the_reference(runs):
    port, ref = _saved(runs, "optimize_sectors", "fits.json")
    assert_close(port, ref, rtol=1e-12, atol=1e-15)


def test_backtest_keeps_the_reference_s_checks(runs):
    (_, _), (_, port) = runs["backtest"]
    assert "sharpe" in port
    assert "total_return_pct" in json.loads(port.strip().splitlines()[-1])
    (_, _), (_, port) = runs["rolling_backtest"]
    assert "Rolling backtest" in port
