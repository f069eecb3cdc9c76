"""The Heston barrier solver (``pde_tpu_torch/solvers/barrier_pde.py``) held
against ``pde_tpu`` (x64) on the CPU.

Gates, each with its reason:
- price, the Greeks and the value grid of the four barrier types, calls
  and puts, the rebate paid at hit and at expiry, spots inside and beyond
  the barrier, Rannacher starts of 0 and 2 steps: 1e-10 relative in
  float64 (the same operators and sweeps), 1e-12 absolute on grid values
  near zero;
- the stretched v grid, its weights and the non-uniform v operator:
  1e-12 relative (closed forms);
- the card's branch forced onto the CPU twin (``kernel_route`` true): in
  float32 each step is two ``thomas_batched`` calls (the v sweep's bands at
  batch stride 0), 2N for a knock-out of N steps and 4N for a knock-in
  (its vanilla march too), within 2e-5 relative of the float32 CPU route
  (a knock-in's price, the vanilla less the out, within 2e-5 of the
  vanilla's);
- the reference suite's oracles (``tests/test_barrier.py``) on the port:
  the four types in the Black-Scholes limit against Reiner-Rubinstein at
  2e-2 (the reference's 150 x 50 x 150), a knocked spot, the rebate's
  bounds; the validation errors.
Grids: 32 x 16 x 16 but for the Black-Scholes limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.solvers import barrier_pde as jb
from pde_tpu.solvers import heston_adi as jh
from pde_tpu_torch import interop
from pde_tpu_torch.models import black_scholes
from pde_tpu_torch.ops import tridiag
from pde_tpu_torch.solvers import barrier_pde as tb
from pde_tpu_torch.solvers import heston_adi as th

jax.config.update("jax_enable_x64", True)

CPU64 = dict(device="cpu", dtype=torch.float64)
GRID = dict(n_spot=32, n_vol=16, n_time=16)
BARRIER = {"up": 130.0, "down": 80.0}
FIELDS = ("price", "delta", "gamma", "vega", "prices", "spot_grid", "vol_grid")


def _close(port, ref, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def _both(bt, S0, is_call=True, **kw):
    jpar = jh.HestonPDEParams(is_call=is_call, q=0.02, **GRID)
    bar = BARRIER[bt.split("-")[0]]
    ref = jb.solve_barrier(jpar, S0, bar, bt, **kw)
    port = tb.solve_barrier(interop.heston_pde_params(jpar), S0, bar, bt, **CPU64, **kw)
    return ref, port


@pytest.mark.parametrize("bt", ["up-and-out", "down-and-out", "up-and-in", "down-and-in"])
@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("S0", [100.0, 135.0, 75.0])
def test_types_and_knocked_spots_match_reference(bt, is_call, S0):
    ref, port = _both(bt, S0, is_call=is_call)
    for f in FIELDS:
        _close(getattr(port, f), getattr(ref, f))


@pytest.mark.parametrize("bt", ["up-and-out", "down-and-out"])
@pytest.mark.parametrize("rebate_at_hit", [True, False])
@pytest.mark.parametrize("n_rannacher", [0, 2])
def test_rebates_and_rannacher_match_reference(bt, rebate_at_hit, n_rannacher):
    ref, port = _both(bt, 100.0, is_call=bt.startswith("down"), rebate=1.5,
                      rebate_at_hit=rebate_at_hit, n_rannacher=n_rannacher)
    for f in FIELDS:
        _close(getattr(port, f), getattr(ref, f))


def test_grid_and_v_operator_match_reference():
    v = tb._sinh_v_grid(16, 1.0, torch.tensor(0.04, dtype=torch.float64))
    jv = jb._sinh_v_grid(16, 1.0, jnp.asarray(0.04))
    _close(v, jv, rtol=1e-12, atol=1e-15)
    for a, b in zip(tb._dv_weights(v), jb._dv_weights(jv)):
        _close(a, b, rtol=1e-12, atol=0.0)
    args = [torch.tensor(a, dtype=torch.float64) for a in (2.0, 0.04, 0.3, 0.05)]
    for a, b in zip(tb._a2_diags_nonuniform(v, *args),
                    jb._a2_diags_nonuniform(jv, 2.0, 0.04, 0.3, 0.05)):
        assert a.dtype == torch.float64
        _close(a, b, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("bt,launches", [("up-and-out", 2), ("down-and-in", 4)])
def test_kernel_branch_on_the_cpu_twin(monkeypatch, bt, launches):
    """The card's route, forced on the CPU: two thomas_batched calls a
    step of each march, the v sweep's bands at batch stride 0."""
    p32 = interop.heston_pde_params(jh.HestonPDEParams(q=0.02, **GRID), dtype=torch.float32)
    bar = BARRIER[bt.split("-")[0]]
    f32 = dict(device="cpu", dtype=torch.float32)
    plain = tb.solve_barrier(p32, 100.0, bar, bt, **f32)
    calls = []
    real = tridiag.thomas_batched

    def spy(lower, diag, upper, rhs):
        calls.append((tuple(rhs.shape), lower.stride(0)))
        return real(lower, diag, upper, rhs)

    monkeypatch.setattr(th, "kernel_route", lambda *ts: True)   # both marches' sweeps
    monkeypatch.setattr(tridiag, "thomas_batched", spy)
    routed = tb.solve_barrier(p32, 100.0, bar, bt, **f32)
    nS, nv = GRID["n_spot"], GRID["n_vol"]
    assert len(calls) == launches * GRID["n_time"]
    assert set(calls[:2 * GRID["n_time"]:2]) == {((nv, nS), nS - 1)}
    assert set(calls[1:2 * GRID["n_time"]:2]) == {((nS, nv), 0)}
    # a knock-in is the vanilla less the out: its error is the marches',
    # 2e-5 of the vanilla price
    scale = float(th.solve(p32, 100.0, **f32).price) if bt.endswith("in") else 0.0
    _close(routed.price, plain.price.numpy(), rtol=2e-5, atol=2e-5 * scale)
    _close(routed.prices, plain.prices.numpy(), rtol=2e-5, atol=1e-4)


def _bs_limit(**kw):
    base = dict(kappa=5.0, theta=0.0625, sigma=0.01, rho=0.0, v0=0.0625, r=0.05, q=0.02,
                T=1.0, K=100.0, is_call=True, n_spot=150, n_vol=50, n_time=150, v_max=0.5)
    base.update(kw)
    return th.HestonPDEParams(**base)


@pytest.mark.parametrize("bt", ["up-and-out", "down-and-out", "up-and-in", "down-and-in"])
def test_black_scholes_limit_is_reiner_rubinstein(bt):
    B = 125.0 if bt.startswith("up") else 85.0
    res = tb.solve_barrier(_bs_limit(), 100.0, B, bt, **CPU64)
    ana = black_scholes.barrier_price(torch.tensor(100.0, dtype=torch.float64), 100.0, B, 0.05,
                                      0.02, 1.0, 0.25, bt, True)
    assert float(res.price) == pytest.approx(float(ana), rel=2e-2, abs=2e-2)


def test_knocked_spot_and_rebate_bounds():
    p = th.HestonPDEParams(q=0.02, **GRID)
    assert float(tb.solve_barrier(p, 130.0, 125.0, "up-and-out", **CPU64).price) == 0.0
    knocked_in = tb.solve_barrier(p, 130.0, 125.0, "up-and-in", **CPU64)
    van = th.solve(p, 130.0, **CPU64)
    assert float(knocked_in.price) == pytest.approx(float(van.price), rel=1e-12)
    no_reb = tb.solve_barrier(p, 100.0, 120.0, "up-and-out", **CPU64)
    reb = tb.solve_barrier(p, 100.0, 120.0, "up-and-out", rebate=3.0, **CPU64)
    assert float(no_reb.price) < float(reb.price) < float(no_reb.price) + 3.0


def test_validation_matches_reference():
    p = th.HestonPDEParams(**GRID)
    jpar = jh.HestonPDEParams(**GRID)
    for args, kw in ((("sideways-and-out",), {}), (("up-and-in",), dict(rebate=1.0)),
                     (("up-and-out",), dict(american=True))):
        american = kw.pop("american", False)
        with pytest.raises(ValueError) as port_err:
            tb.solve_barrier(p._replace(american=american), 100.0, 120.0, *args, **kw, **CPU64)
        with pytest.raises(ValueError) as ref_err:
            jb.solve_barrier(jpar._replace(american=american), 100.0, 120.0, *args, **kw)
        assert str(port_err.value) == str(ref_err.value)
