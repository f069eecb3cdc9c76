"""The port's command line against ``pde_tpu.cli``: the rates and credit
desk, calibration, the demo and the pricing server's wiring.

Both packages run the argv of ``tests/test_system.py`` (the port with
``--device cpu`` and torch's default dtype float64, the reference under
x64).  Gates, each that of the module's own parity file:
- ``rates`` and ``credit`` (curves, caplets, swaptions, the Bermudan PDE,
  hazards, CVA): 1e-8 relative, 1e-12 absolute; the reference's eager
  Jamshidian Newton sits ~1e-10 from its compiled self
  (``tests/test_torch_rates.py``);
- the cap-vol strip's Hull-White refit: the stripped vols and prices at
  1e-8, the fitted ``(a, sigma)`` and rmse at 1e-6 of the reference's
  (the LM fits are deterministic, ``tests/test_torch_calibrate_rates.py``);
- ``calibrate`` and ``demo``: DE draws differ by design (Philox against
  threefry), so the converged Heston parameters agree within 1e-4 of each
  other and of the truth (``tests/test_torch_calibrate.py``), both fits
  succeed, and the rest of the demo (OU fit, signals, backtest) is equal
  once both packages fit one synthetic spread (the port simulates its own
  with torch's draws).
Also: ``rates --cap-vols`` with fewer vols than maturities exits 2 with a
message (the reference truncates the maturities without a word), and
``serve`` hands its options, the device and the working dtype to
``serving.run_server``.
"""

import re

import numpy as np
import pytest
import torch

from pde_tpu.calibrate import OUFitter as RefOUFitter
from pde_tpu_torch import cli as port_cli
from pde_tpu_torch.calibrate import OUFitter as PortOUFitter
from torch_cli_parity import Runs, assert_close, float64_default, run

ARGV = {
    "rates": ["rates", "--caplet-starts", "1.0", "2.0", "--swaption-expiries", "1.0",
              "--swap-tenor", "2.0"],
    "rates_bermudan": ["rates", "--bermudan", "--swaption-expiries", "1.0", "--swap-tenor",
                       "2.0", "--caplet-starts", "1.0"],
    "rates_cap_vols": ["rates", "--cap-vols", "0.25", "0.22", "--cap-maturities", "1.0", "2.0",
                       "--caplet-starts", "1.0", "--swaption-expiries", "1.0"],
    "credit": ["credit", "--pillars", "1.0", "3.0", "--spreads", "0.008", "0.011",
               "--cva-tenor", "2.0"],
    "calibrate": ["calibrate", "--n-strikes", "7", "--n-maturities", "2", "--maxiter", "30",
                  "--popsize", "8"],
    "demo": ["demo"],
}
DESK = dict(rtol=1e-8, atol=1e-12)
HESTON_FIELDS = ("kappa", "theta", "sigma", "rho", "v0")
TRUE = dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04)


@pytest.fixture(scope="module")
def spread():
    """One synthetic OU spread for both demos (the reference's own)."""
    return np.asarray(RefOUFitter.generate_synthetic_data(n_points=750, seed=42))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, spread):
    mp = pytest.MonkeyPatch()
    for cls in (RefOUFitter, PortOUFitter):
        mp.setattr(cls, "generate_synthetic_data", staticmethod(lambda *a, **k: spread.copy()))
    yield Runs(ARGV, tmp_path_factory.mktemp("cli_desk"))
    mp.undo()


@pytest.mark.parametrize("name", ["rates", "rates_bermudan", "credit"])
def test_desk_matches_the_reference(runs, name):
    port, ref = runs.json(name)
    assert_close(port, ref, **DESK)


def test_cap_vol_strip_matches_the_reference(runs):
    port, ref = runs.json("rates_cap_vols")
    fit_p, fit_r = port["cap_vol_strip"].pop("fitted"), ref["cap_vol_strip"].pop("fitted")
    assert_close(port, ref, **DESK)
    assert fit_p["converged"] and fit_r["converged"]
    for k in ("a", "sigma", "rmse"):
        np.testing.assert_allclose(fit_p[k], fit_r[k], rtol=1e-6, err_msg=k)


def test_bermudan_keeps_the_reference_s_checks(runs):
    bm = runs.json("rates_bermudan")[0]["atm_bermudan"]
    assert bm["payer_price"] >= bm["european_price"] - 1e-6
    assert bm["early_exercise_premium"] == pytest.approx(
        bm["payer_price"] - bm["european_price"], abs=1e-12)


def test_calibrate_converges_to_the_reference_s_fit(runs):
    port, ref = runs.json("calibrate")
    assert port["success"] and ref["success"]
    for k in HESTON_FIELDS:
        assert abs(port["params"][k] - TRUE[k]) < 1e-4, k
        assert abs(port["params"][k] - ref["params"][k]) < 1e-4, k
    assert port["rmse"] < 1e-4 and ref["rmse"] < 1e-4
    assert set(port) == set(ref)


def _demo_lines(out):
    """The demo's lines with the Heston fit's line parsed apart."""
    lines = out.strip().splitlines()
    fit = next(i for i, ln in enumerate(lines) if ln.strip().startswith("rmse="))
    nums = [float(x) for x in re.findall(r"[-+]?\d+\.\d+", lines[fit])]
    return lines[:fit] + lines[fit + 1:], nums


def test_demo_matches_the_reference(runs):
    (ref_rc, ref), (port_rc, port) = runs["demo"]
    assert ref_rc == 0 and port_rc == 0
    port_lines, port_fit = _demo_lines(port)
    ref_lines, ref_fit = _demo_lines(ref)
    assert port_lines[0] == "== pde_tpu_torch demo ==" and ref_lines[0] == "== pde_tpu demo =="
    # rmse, kappa, v0 as printed (4, 2 and 4 decimals)
    for got, want, atol in zip(port_fit, ref_fit, (1e-4, 1e-2, 1e-4), strict=True):
        assert abs(got - want) <= atol + 1e-12, (port_fit, ref_fit)
    assert port_lines[1:] == ref_lines[1:]


def test_cap_vols_of_another_length_exit_2(capsys):
    with float64_default():
        rc = port_cli.main(["--device", "cpu", "rates", "--cap-vols", "0.25", "0.22",
                            "--cap-maturities", "1.0", "2.0", "3.0"])
    assert rc == 2
    captured = capsys.readouterr()
    assert "--cap-vols and --cap-maturities must align" in captured.err
    assert captured.out == ""


def test_serve_wires_run_server(monkeypatch):
    import pde_tpu_torch.serving as serving

    calls = []
    monkeypatch.setattr(serving, "run_server", lambda **kw: calls.append(kw))
    with float64_default():
        rc, out = run(port_cli.main, ["--device", "cpu", "serve", "--port", "9191",
                                      "--max-wait-ms", "3.5", "--host", "127.0.0.1"])
    assert rc == 0 and out == ""
    assert calls == [dict(host="127.0.0.1", port=9191, max_wait_ms=3.5,
                          device=torch.device("cpu"), dtype=torch.float64)]
