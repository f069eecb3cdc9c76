"""``pde_tpu_torch.solvers.heston_adi_ref`` against the C++ reference's own
numbers (``tests/golden/reference_pde_values.json``) and against its JAX
twin, on the CPU in float64.

Mirrors ``TestHestonADIGolden`` (``tests/test_golden_pde.py:83-120``):
- the four golden cases at 1e-10 (vega 1e-9);
- the whole value grid, the spot and variance grids and every Greek
  against ``pde_tpu.solvers.heston_adi_ref.solve_reference`` under x64 at
  1e-10;
- the defect documentation: the port's Douglas march lands within 0.5% of
  the port's converged Carr-Madan price, where the reference's scheme is
  more than 5% (call) and 15% (put) off;
- ``_nearest_index`` sends a midpoint tie to the right-hand point, as the
  reference's strict ``<`` does.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.solvers import heston_adi as jadi
from pde_tpu.solvers import heston_adi_ref as jref
from pde_tpu_torch.solvers import heston_adi, heston_adi_ref

with open(os.path.join(os.path.dirname(__file__), "golden", "reference_pde_values.json")) as fh:
    GOLD = json.load(fh)

HESTON_REF = dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04, r=0.05, q=0.0, T=1.0,
                  K=100.0, is_call=True)
SECOND = dict(kappa=1.5, theta=0.09, sigma=0.5, rho=-0.5, v0=0.06, r=0.03, q=0.01, T=0.5,
              K=110.0, is_call=True)
# case -> (params, golden fields by result field)
CASES = {
    "euro_call": (HESTON_REF, {"price": "heston_pde_euro_call_price",
                               "delta": "heston_pde_euro_call_delta",
                               "gamma": "heston_pde_euro_call_gamma",
                               "vega": "heston_pde_euro_call_vega"}),
    "euro_put": (dict(HESTON_REF, is_call=False), {"price": "heston_pde_euro_put_price"}),
    "amer_put": (dict(HESTON_REF, is_call=False, american=True),
                 {"price": "heston_pde_amer_put_price"}),
    "second_set": (SECOND, {"price": "heston_pde2_euro_call_price"}),
}
TOL = {"vega": 1e-9}


@pytest.fixture(scope="module")
def solved():
    return {name: heston_adi_ref.solve_reference(heston_adi.HestonPDEParams(**kw), 100.0,
                                                 device="cpu")
            for name, (kw, _) in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_golden_case(solved, case):
    res = solved[case]
    for field, key in CASES[case][1].items():
        value = getattr(res, field)
        assert value.dtype == torch.float64 and value.device.type == "cpu"
        assert float(value) == pytest.approx(GOLD[key], abs=TOL.get(field, 1e-10)), field


@pytest.mark.parametrize("case", ["euro_call", "amer_put"])
def test_whole_grid_matches_the_jax_twin(solved, case):
    res = solved[case]
    ref = jref.solve_reference(jadi.HestonPDEParams(**CASES[case][0]), 100.0)
    for field in res._fields:
        np.testing.assert_allclose(getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=0, atol=1e-10, err_msg=field)


def test_port_s_solver_beats_the_reference_against_the_semi_analytic_price(solved):
    from pde_tpu_torch.models import heston as hm

    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    params = hm.HestonParams(f64(2.0), f64(0.04), f64(0.3), f64(-0.7), f64(0.04))
    truth_call = float(hm.price_accurate(params, f64(100.0), f64(1.0), f64(100.0), 0.05, 0.0,
                                         True))
    truth_put = float(hm.price_accurate(params, f64(100.0), f64(1.0), f64(100.0), 0.05, 0.0,
                                        False))
    ours = float(heston_adi.solve(heston_adi.HestonPDEParams(**HESTON_REF), 100.0,
                                  device="cpu", dtype=torch.float64).price)
    assert abs(ours - truth_call) / truth_call < 5e-3
    assert abs(float(solved["euro_call"].price) - truth_call) / truth_call > 0.05
    assert abs(float(solved["euro_put"].price) - truth_put) / truth_put > 0.15


@pytest.mark.parametrize("x", [0.5, 1.5, 2.0, -1.0, 9.0, 1.25, 2.75])
def test_nearest_index_ties_go_right(x):
    grid = np.array([0.0, 1.0, 2.0, 3.0, 4.0])
    got = heston_adi_ref._nearest_index(torch.as_tensor(grid),
                                        torch.tensor(x, dtype=torch.float64))
    assert int(got) == int(jref._nearest_index(jnp.asarray(grid), jnp.asarray(x)))
    if x in (0.5, 1.5):
        assert int(got) == int(x + 0.5)


def test_solve_reference_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        heston_adi_ref.solve_reference(heston_adi.HestonPDEParams(n_spot=8, n_vol=5, n_time=2),
                                       100.0)
