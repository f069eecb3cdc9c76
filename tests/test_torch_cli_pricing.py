"""The port's command line against ``pde_tpu.cli``: the pricing subcommands.

``price``, ``varswap``, ``vix``, ``fwdstart`` and ``pide`` run in both
packages on the argv of ``tests/test_system.py`` (the port with ``--device
cpu`` and torch's default dtype float64, the reference under x64), and the
printed JSON is compared field by field.  Gates, each that of the module's
own parity file:
- Fourier and closed-form routes (``price --method cf``/``digital``,
  ``varswap``, ``vix``, ``fwdstart``): 1e-8 relative on prices, strikes
  and probabilities (1e-12 absolute), 1e-6 absolute on implied vols
  (``tests/test_torch_heston.py``);
- the ADI PDE (``price --method pde``/``greeks``): 1e-8 relative
  (``tests/test_torch_heston_adi_scan.py``), 1e-12 absolute;
- the PIDE strips: 1e-10 relative, 1e-12 absolute
  (``tests/test_torch_pide.py``), the oracle's error at 1e-8 of itself.
Also: without a card and without ``--device`` the command line raises the
port's no-card error instead of running on the CPU; ``--device`` comes
before the subcommand (after it, argparse refuses it); ``python -m
pde_tpu_torch.cli`` runs.
"""

import runpy
import sys

import pytest
import torch

from pde_tpu_torch import cli as port_cli
from torch_cli_parity import Runs, assert_close

ARGV = {
    "price_cf": ["price", "--method", "cf", "--strikes", "90", "100", "110"],
    "price_pde_american_put": ["price", "--method", "pde", "--put", "--american",
                               "--strikes", "100", "--spot", "90", "--rate", "0.08",
                               "--dividend", "0"],
    "price_digital": ["price", "--method", "digital", "--strikes", "90", "100", "110"],
    "price_greeks": ["price", "--method", "greeks", "--strikes", "100"],
    "varswap_bates": ["varswap", "--maturities", "0.25", "1.0", "--lam", "0.6",
                      "--mu-j", "-0.08", "--sigma-j", "0.18"],
    "varswap_heston": ["varswap", "--maturities", "0.25"],
    "vix_options": ["vix", "--maturities", "0.25", "0.5", "--strikes", "18", "22", "26",
                    "--rate", "0.03"],
    "vix_bates": ["vix", "--lam", "0.5", "--maturities", "0.25"],
    "fwdstart_cliquet": ["fwdstart", "--rel-strikes", "0.9", "1.0", "1.1", "--fixing", "0.5",
                         "--maturity", "1.0", "--cliquet-periods", "4"],
    "pide_merton_oracle": ["pide", "--jumps", "merton", "--oracle-check", "--strikes", "90",
                           "100", "110", "--n-space", "256", "--n-time", "64"],
    "pide_kou_american_put": ["pide", "--jumps", "kou", "--put", "--american", "--strikes",
                              "120", "--n-space", "256", "--n-time", "64"],
}
FOURIER = dict(rtol=1e-8, atol=1e-12, gates={"implied_vols": (0.0, 1e-6),
                                             "black76_iv": (0.0, 1e-6)})
GATES = {
    "price_cf": FOURIER,
    "price_pde_american_put": dict(rtol=1e-8, atol=1e-12),
    "price_digital": FOURIER,
    "price_greeks": dict(rtol=1e-8, atol=1e-12),
    "varswap_bates": FOURIER,
    "varswap_heston": FOURIER,
    "vix_options": FOURIER,
    "vix_bates": FOURIER,
    "fwdstart_cliquet": FOURIER,
    "pide_merton_oracle": dict(rtol=1e-10, atol=1e-12,
                               gates={"oracle_max_abs_err": (1e-8, 0.0)}),
    "pide_kou_american_put": dict(rtol=1e-10, atol=1e-12),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return Runs(ARGV, tmp_path_factory.mktemp("cli_pricing"))


@pytest.mark.parametrize("name", list(ARGV))
def test_matches_the_reference(runs, name):
    port, ref = runs.json(name)
    assert_close(port, ref, **GATES[name])


def test_price_pde_keeps_the_reference_s_checks(runs):
    """The reference test's own checks hold on the port's output."""
    port, _ = runs.json("price_pde_american_put")
    assert port["american"] and port["prices"][0] >= 10.0
    port, _ = runs.json("pide_merton_oracle")
    rows = port["rows"]
    assert rows[0]["price"] > rows[1]["price"] > rows[2]["price"] > 0
    assert port["oracle_max_abs_err"] < 0.05


def test_without_a_card_the_command_line_raises(monkeypatch):
    """No ``--device`` and no card: the default-device error, not a quiet
    CPU run (on a machine with a card this test still sees none)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["price", "--method", "cf"])


@pytest.mark.parametrize("where", ["before", "after"])
def test_device_before_or_after_the_subcommand(where, capsys):
    """``--device`` is a top-level option: before the subcommand it runs
    there, after it the parser refuses it (exit 2)."""
    argv = ["varswap", "--maturities", "0.25"]
    if where == "after":
        with pytest.raises(SystemExit) as done:
            port_cli.main([*argv, "--device", "cpu"])
        assert done.value.code == 2
        assert "unrecognized arguments: --device cpu" in capsys.readouterr().err
        return
    assert port_cli.main(["--device", "cpu", *argv]) == 0
    assert '"model": "heston"' in capsys.readouterr().out
    assert port_cli.build_parser().parse_args(["--device", "cpu", *argv]).device == "cpu"


def test_module_entry_point_runs(monkeypatch, capsys):
    """``python -m pde_tpu_torch.cli`` (the console script's target) runs
    ``main`` and exits with its code."""
    monkeypatch.setattr(sys, "argv", ["pde_tpu_torch.cli", "--device", "cpu", "varswap",
                                      "--maturities", "0.5"])
    monkeypatch.delitem(sys.modules, "pde_tpu_torch.cli")
    with pytest.raises(SystemExit) as done:
        runpy.run_module("pde_tpu_torch.cli", run_name="__main__")
    assert done.value.code == 0
    assert '"variance_strike"' in capsys.readouterr().out
