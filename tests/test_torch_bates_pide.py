"""The Bates 2D PIDE solver (``pde_tpu_torch/solvers/bates_pide.py``) held
against ``pde_tpu`` (x64) on the CPU.

Gates, each with its reason:
- price, the Greeks and the value grid over both jump families, calls and
  puts, European, American by projection and by Ikonen-Toivanen: 1e-10
  relative in float64 (the same operators and sweeps), 1e-12 absolute on
  grid values near zero;
- the card's branch forced onto the CPU twin (``kernel_route`` true): in
  float32 each step is two ``thomas_batched`` calls, the S sweep on
  (nv, nS) with a band row a variance level and the v sweep on (nS, nv)
  with its bands expanded over the rows (batch stride 0), 2 * n_time calls,
  within 2e-5 relative of the float32 CPU route;
- the reference suite's oracles (``tests/test_bates_pide.py``) on the
  port: lam = 0 is the port's ``heston_adi.solve`` to 1e-10 (same
  operators, the jump path adding zeros); the American put above the
  European, and projection and Ikonen-Toivanen within 2e-2; the
  validation errors.
Grids: 32 x 16 x 16, one oracle at 48 x 24 x 24.
"""

import jax
import numpy as np
import pytest
import torch

from pde_tpu.solvers import bates_pide as jb
from pde_tpu.solvers import pide as jp
from pde_tpu_torch import interop
from pde_tpu_torch.ops import tridiag
from pde_tpu_torch.solvers import bates_pide as tb
from pde_tpu_torch.solvers import heston_adi

jax.config.update("jax_enable_x64", True)

CPU64 = dict(device="cpu", dtype=torch.float64)
S0 = 100.0
GRID = dict(n_spot=32, n_vol=16, n_time=16)
JUMPS = {"merton": jp.MertonJumps(0.5, -0.1, 0.15), "kou": jp.KouJumps(1.0, 0.4, 10.0, 5.0)}
MODES = {"european": dict(american=False), "projection": dict(american=True),
         "it_lcp": dict(american=True, american_method="it_lcp")}
FIELDS = ("price", "delta", "gamma", "vega", "theta", "prices", "spot_grid", "vol_grid")


def _close(port, ref, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("family", sorted(JUMPS))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("is_call", [True, False])
def test_solve_matches_reference(family, mode, is_call):
    jpar = jb.BatesPIDEParams(q=0.02, is_call=is_call, jumps=JUMPS[family], **MODES[mode],
                              **GRID)
    ref = jb.solve_bates_pide(jpar, S0)
    port = tb.solve_bates_pide(interop.bates_pide_params(jpar), S0, **CPU64)
    for f in FIELDS:
        _close(getattr(port, f), getattr(ref, f))


def test_kernel_branch_on_the_cpu_twin(monkeypatch):
    """The card's route, forced on the CPU: two thomas_batched calls a
    step, the v sweep's bands at batch stride 0."""
    jpar = jb.BatesPIDEParams(q=0.02, is_call=False, american=True, american_method="it_lcp",
                              jumps=JUMPS["merton"], **GRID)
    p32 = interop.bates_pide_params(jpar, dtype=torch.float32)
    f32 = dict(device="cpu", dtype=torch.float32)
    plain = tb.solve_bates_pide(p32, S0, **f32)
    calls = []
    real = tridiag.thomas_batched

    def spy(lower, diag, upper, rhs):
        calls.append((tuple(rhs.shape), lower.stride(0), diag.stride(0), upper.stride(0)))
        return real(lower, diag, upper, rhs)

    monkeypatch.setattr(heston_adi, "kernel_route", lambda *ts: True)  # its sweeps
    monkeypatch.setattr(tridiag, "thomas_batched", spy)
    routed = tb.solve_bates_pide(p32, S0, **f32)
    nS, nv = GRID["n_spot"], GRID["n_vol"]
    assert len(calls) == 2 * GRID["n_time"]
    assert set(calls[0::2]) == {((nv, nS), nS - 1, nS, nS - 1)}
    assert set(calls[1::2]) == {((nS, nv), 0, 0, 0)}
    _close(routed.price, plain.price.numpy(), rtol=2e-5, atol=0.0)
    _close(routed.prices, plain.prices.numpy(), rtol=2e-5, atol=1e-4)


def test_zero_intensity_is_heston_adi():
    p = tb.BatesPIDEParams(q=0.02, jumps=tb.MertonJumps(0.0, 0.0, 0.2), **GRID)
    r0 = tb.solve_bates_pide(p, S0, **CPU64)
    h0 = heston_adi.solve(heston_adi.HestonPDEParams(q=0.02, **GRID), S0, **CPU64)
    assert abs(float(r0.price) - float(h0.price)) < 1e-10


def test_american_put_bounds_and_methods_agree():
    grid = dict(n_spot=48, n_vol=24, n_time=24)
    p = tb.BatesPIDEParams(q=0.02, is_call=False, **grid)
    euro = tb.solve_bates_pide(p, S0, **CPU64)
    proj = tb.solve_bates_pide(p._replace(american=True), S0, **CPU64)
    it = tb.solve_bates_pide(p._replace(american=True, american_method="it_lcp"), S0, **CPU64)
    assert float(proj.price) >= float(euro.price) >= 0.0
    assert abs(float(proj.price) - float(it.price)) < 2e-2
    assert float(proj.price) - float(euro.price) > 0.1


def test_validation_matches_reference():
    for bad, exc in ((dict(jumps=object()), TypeError), (dict(american_method="x"), ValueError),
                     (dict(n_vol=7), ValueError)):
        with pytest.raises(exc) as port_err:
            tb.solve_bates_pide(tb.BatesPIDEParams(**bad), S0, **CPU64)
        with pytest.raises(exc) as ref_err:
            jb.solve_bates_pide(jb.BatesPIDEParams(**bad), S0)
        assert str(port_err.value) == str(ref_err.value)
