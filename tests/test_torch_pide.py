"""The jump-diffusion PIDE solver (``pde_tpu_torch/solvers/pide.py``) held
against ``pde_tpu`` (x64) on the CPU.

Gates, each with its reason:
- the march (price, delta, gamma and the value grid) over both jump
  families, calls and puts, European and American, Crank-Nicolson with one
  and two fixed-point passes and the implicit scheme: 1e-10 relative in
  float64 (the same arithmetic; the port leads with the strikes, the
  reference transposes around every solve), 1e-12 absolute on grid values
  near zero;
- ``_jump_matrix``, the tails and ``kou_reference_price``: 1e-12 (closed
  forms; the Kou diagonal exactly its mid value);
- the card's branch forced onto the CPU twin (``kernel_route`` true): in
  float32 every fixed-point pass is one ``thomas_batched`` call on the
  (B, n) strip with the bands expanded over it (batch stride 0),
  n_time * fp_iterations calls, within 2e-5 relative of the float32 CPU
  route (the twin takes one reciprocal a pivot, the factored solve its
  own);
- the reference suite's oracles (``tests/test_pide.py``) once each on the
  port, at its tolerances: the Merton series (3e-3 rel + 5e-3 abs, at
  the reference's 512 x 128), Gil-Pelaez for Kou (the same gate, met at
  256 x 64 with margin), lam = 0 against the port's ``bs_pde`` (2e-2), a
  strip equal to scalar solves, the American put above the European and
  the intrinsic; and the validation errors.
Grids: 64-128 points, 12-32 steps except where an oracle needs the
reference's size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.solvers import pide as jp
from pde_tpu_torch import interop
from pde_tpu_torch.models.bates import merton_reference_price
from pde_tpu_torch.ops import tridiag
from pde_tpu_torch.solvers import bs_pde
from pde_tpu_torch.solvers import pide as tp

jax.config.update("jax_enable_x64", True)

CPU64 = dict(device="cpu", dtype=torch.float64)
S0, R, Q, SIG, T = 100.0, 0.05, 0.02, 0.2, 0.5
KS = np.array([80.0, 90.0, 100.0, 110.0, 120.0])
J_MERTON = jp.MertonJumps(0.5, -0.1, 0.15)
J_KOU = jp.KouJumps(1.0, 0.4, 10.0, 5.0)
FAMILIES = {"merton": (J_MERTON, interop.merton_jumps), "kou": (J_KOU, interop.kou_jumps)}


def _close(port, ref, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def _both(family, **kw):
    j, conv = FAMILIES[family]
    ref = jp.solve_pide(j, SIG, R, Q, T, KS, S0, **kw)
    port = tp.solve_pide(conv(j), SIG, R, Q, T, KS, S0, **CPU64, **kw)
    return ref, port


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("american", [False, True])
def test_march_matches_reference(family, is_call, american):
    ref, port = _both(family, is_call=is_call, american=american, n_space=64, n_time=12)
    for f in ("price", "delta", "gamma", "prices", "spot_grid"):
        _close(getattr(port, f), getattr(ref, f))


@pytest.mark.parametrize("scheme,fp", [("crank_nicolson", 1), ("implicit", 1), ("implicit", 2)])
def test_schemes_and_passes_match_reference(scheme, fp):
    ref, port = _both("kou", is_call=False, american=True, n_space=96, n_time=16,
                      scheme=scheme, fp_iterations=fp)
    for f in ("price", "delta", "gamma", "prices"):
        _close(getattr(port, f), getattr(ref, f))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jump_matrix_and_tails_match_reference(family):
    j, conv = FAMILIES[family]
    t = conv(j)
    x_np = np.linspace(np.log(0.1), np.log(10.0), 65)
    dx = (x_np[-1] - x_np[0]) / 64
    W = tp._jump_matrix(t, torch.tensor(x_np), torch.tensor(dx))
    _close(W, jp._jump_matrix(j, jnp.asarray(x_np), jnp.asarray(dx)), rtol=1e-12, atol=0.0)
    if family == "kou":
        # the kink: the diagonal takes the mean of the one-sided limits
        mid = 0.5 * (0.4 * 10.0 + 0.6 * 5.0)
        _close(torch.diagonal(W)[1:-1], np.full(63, mid * dx), rtol=1e-15, atol=0.0)
    z = np.array([-0.7, -0.05, 0.0, 0.05, 0.7])
    for name in ("tail_up", "tail_down"):
        for a, b in zip(getattr(t, name)(torch.tensor(z)), getattr(j, name)(jnp.asarray(z))):
            _close(a, b, rtol=1e-12, atol=1e-15)
    _close(t.kbar, j.kbar, rtol=1e-12, atol=0.0)
    # the tails close: total mass 1 and e^y-mass 1 + kbar on both sides
    bu, au = t.tail_up(torch.tensor(z))
    bd, ad = t.tail_down(torch.tensor(z))
    _close(bu + bd, np.ones(5), rtol=0.0, atol=1e-12)
    _close(au + ad, np.full(5, 1.0 + float(t.kbar)), rtol=0.0, atol=1e-12)


def test_kou_reference_price_is_the_reference_oracle():
    for is_call in (True, False):
        _close(tp.kou_reference_price(KS, T, S0, R, Q, SIG, *J_KOU, is_call=is_call),
               jp.kou_reference_price(KS, T, S0, R, Q, SIG, *J_KOU, is_call=is_call),
               rtol=1e-12, atol=0.0)


def test_kernel_branch_on_the_cpu_twin(monkeypatch):
    """The card's route, forced on the CPU: float32, one thomas_batched
    call a fixed-point pass on the whole strip, bands at batch stride 0."""
    f32 = dict(device="cpu", dtype=torch.float32)
    jumps = interop.merton_jumps(J_MERTON, dtype=torch.float32)
    kw = dict(is_call=False, american=True, n_space=64, n_time=16, fp_iterations=2)
    plain = tp.solve_pide(jumps, SIG, R, Q, T, KS, S0, **f32, **kw)
    calls, strides = [], set()
    real = tridiag.thomas_batched

    def spy(lower, diag, upper, rhs):
        calls.append(tuple(rhs.shape))
        strides.update((lower.stride(0), diag.stride(0), upper.stride(0)))
        return real(lower, diag, upper, rhs)

    monkeypatch.setattr(tp, "kernel_route", lambda *ts: True)
    monkeypatch.setattr(tridiag, "thomas_batched", spy)
    routed = tp.solve_pide(jumps, SIG, R, Q, T, KS, S0, **f32, **kw)
    assert len(calls) == 16 * 2 and set(calls) == {(5, 64)} and strides == {0}
    _close(routed.price, plain.price.numpy(), rtol=2e-5, atol=0.0)
    _close(routed.prices, plain.prices.numpy(), rtol=2e-5, atol=1e-4)


def test_merton_against_the_series():
    """The call strip at the reference's default grid (512 x 128)."""
    res = tp.solve_pide(interop.merton_jumps(J_MERTON), SIG, R, Q, T, KS, S0, **CPU64)
    ref = merton_reference_price(KS, T, S0, R, Q, SIG, *J_MERTON)
    _close(res.price, ref, rtol=3e-3, atol=5e-3)


def test_kou_against_gil_pelaez():
    res = tp.solve_pide(interop.kou_jumps(J_KOU), SIG, R, Q, T, KS, S0, is_call=False,
                        n_space=256, n_time=64, **CPU64)
    ref = tp.kou_reference_price(KS, T, S0, R, Q, SIG, *J_KOU, is_call=False)
    _close(res.price, ref, rtol=3e-3, atol=5e-3)


def test_zero_intensity_is_the_bs_pde():
    none = tp.MertonJumps(0.0, 0.0, 0.2)
    res = tp.solve_pide(none, SIG, R, Q, 1.0, 100.0, S0, n_space=256, n_time=64, **CPU64)
    base = bs_pde.solve(bs_pde.BSPDEParams(sigma=SIG, r=R, q=Q, T=1.0, K=100.0,
                                           n_space=256, n_time=64), S0, **CPU64)
    assert abs(float(res.price[0]) - float(base.price)) < 2e-2


def test_strip_equals_scalar_solves_and_american_bounds():
    kou = interop.kou_jumps(J_KOU)
    kw = dict(is_call=False, n_space=128, n_time=32, **CPU64)
    strip = tp.solve_pide(kou, SIG, R, Q, T, KS, S0, **kw)
    for i, k in enumerate(KS):
        solo = tp.solve_pide(kou, SIG, R, Q, T, float(k), S0, **kw)
        assert abs(float(strip.price[i]) - float(solo.price[0])) < 1e-12
    amer = tp.solve_pide(kou, SIG, R, Q, T, KS, S0, american=True, **kw)
    a, e = amer.price.numpy(), strip.price.numpy()
    assert np.all(a >= e - 1e-10)
    assert np.all(a >= np.maximum(KS - S0, 0.0) - 1e-10)


def test_validation_matches_reference():
    m = interop.merton_jumps(J_MERTON)
    for bad, exc in ((dict(jumps=object()), TypeError), (dict(scheme="explicit"), ValueError),
                     (dict(fp_iterations=0), ValueError), (dict(n_space=8), ValueError),
                     (dict(n_time=9), ValueError)):
        kw = dict(bad)
        jumps = kw.pop("jumps", m)
        with pytest.raises(exc) as port_err:
            tp.solve_pide(jumps, SIG, R, Q, T, KS, S0, **CPU64, **kw)
        with pytest.raises(exc) as ref_err:
            jp.solve_pide(J_MERTON if jumps is m else jumps, SIG, R, Q, T, KS, S0, **kw)
        assert str(port_err.value) == str(ref_err.value)
