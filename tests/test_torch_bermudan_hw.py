"""The Hull-White Bermudan swaption engines (``pde_tpu_torch/solvers/
bermudan_hw.py``) held against ``pde_tpu`` (x64) on the CPU.

Gates, each with its reason:
- the closed forms (``hw_alpha_integral``, ``hw_joint_increment_moments``,
  ``remaining_swap_value``), the march plan and the PDE march: 1e-10
  relative in float64 (the same arithmetic; the march's Thomas solves
  divide as the reference's ``thomas`` does);
- the strike ladder: ONE batched march of ``(S, n_x)`` systems against the
  reference's march per strike (its ``vmap`` in ``bench_full.py``), 1e-10;
- the card's branch forced onto the CPU twin (``kernel_route`` true): in
  float32 every step is one ``thomas_batched`` call on the whole ladder
  with the bands expanded over it (batch stride 0), 160 calls for the
  bench's schedule (1.0 to 6.0 by 0.5, ``n_sub`` 16), and the result within
  2e-5 relative of the float32 ``thomas`` route (the twin takes one
  reciprocal a pivot where ``thomas`` divides);
- the Monte Carlo sandwich and its event simulation on the reference's
  own draws (``jax_key_draws.JaxKey``: ``(reg, outer, inner)``, a source a
  step, ``(next, draw)`` chains): 1e-10 relative in float64;
- the reference suite's checks (``tests/test_bermudan_hw.py``) on the
  port: the curve reproduced by the joint moments (1e-12), the European
  collapse of the PDE (2e-3 at 401 x 24) and of the sandwich (4 s.e.),
  the PDE inside the sandwich and above the best European, more exercise
  dates never cheaper, payer and receiver in their places.
Sizes: at most 4096 paths; PDE grids of 33 to 101 points, one European
collapse at the reference's 401 x 24 (24 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey

from pde_tpu.models import rates as jrates
from pde_tpu.solvers import bermudan_hw as jb
from pde_tpu_torch import interop
from pde_tpu_torch.models import rates as trates
from pde_tpu_torch.ops import tridiag
from pde_tpu_torch.solvers import bermudan_hw as tb

F64 = torch.float64
CPU = torch.device("cpu")
REL = dict(rtol=1e-10, atol=0.0)
TIMES = [0.5, 1.0, 2.0, 5.0, 10.0, 30.0]
ZEROS = [0.030, 0.032, 0.035, 0.040, 0.042, 0.043]
SCHED = np.arange(1.0, 5.01, 0.5)  # 1y into 4y, semi-annual
BENCH_SCHED = np.arange(1.0, 6.01, 0.5)


@pytest.fixture(scope="module")
def hw():
    curve = jrates.curve_from_zero_rates(jnp.array(TIMES), jnp.array(ZEROS))
    j = jrates.HullWhiteParams(jnp.asarray(0.1), jnp.asarray(0.012), curve)
    return j, interop.hull_white_params(j)


@pytest.fixture(scope="module")
def atm(hw):
    return float(jrates.hw_swap_rate(hw[0].curve, 1.0, jnp.asarray(SCHED[1:])))


def _close(got, want, **gate):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want),
                               **(gate or REL))


def test_closed_forms_match_reference(hw, atm):
    j, t = hw
    t1, t2 = np.array([0.0, 0.5, 1.0, 3.0]), np.array([0.5, 1.7, 3.0, 10.0])
    _close(tb.hw_alpha_integral(t, torch.tensor(t1), torch.tensor(t2)),
           jb.hw_alpha_integral(j, jnp.asarray(t1), jnp.asarray(t2)))
    for g, w in zip(tb.hw_joint_increment_moments(t, torch.tensor(t2 - t1)),
                    jb.hw_joint_increment_moments(j, jnp.asarray(t2 - t1))):
        _close(g, w)
    x = np.linspace(-0.05, 0.05, 11)
    for jj in (0, 3, 7):
        for payer in (True, False):
            _close(tb.remaining_swap_value(t, atm, torch.tensor(SCHED), jj, torch.tensor(x),
                                           payer=payer),
                   jb.remaining_swap_value(j, atm, jnp.asarray(SCHED), jj, jnp.asarray(x),
                                           payer=payer))
    # a strike column against an x-grid: one row a strike
    ks = np.array([0.02, atm, 0.05])
    ladder = tb.remaining_swap_value(t, torch.tensor(ks)[:, None], torch.tensor(SCHED), 2,
                                     torch.tensor(x))
    assert ladder.shape == (3, 11)
    for row, k in zip(ladder, ks):
        _close(row, jb.remaining_swap_value(j, k, jnp.asarray(SCHED), 2, jnp.asarray(x)))


def test_march_plan_matches_reference():
    ex = (True, False, True, True, False, True, False, False)
    want = jb._march_plan(jnp.asarray(SCHED), ex, 5, jnp.float64)
    got = tb._march_plan(torch.tensor(SCHED), ex, 5, F64)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))
    assert got[4] == want[4] == 5


PDE_CASES = {
    "payer_all_dates": dict(),
    "receiver_gapped_exercise": dict(payer=False,
                                     exercise=(True, False, True, True, False, True, False,
                                               False)),
}


@pytest.mark.parametrize("case", sorted(PDE_CASES))
def test_pde_matches_reference(hw, atm, case):
    j, t = hw
    kw = dict(n_x=33, n_sub=4, **PDE_CASES[case])
    want = jb.bermudan_swaption_pde(j, atm, jnp.asarray(SCHED), **kw)
    got = tb.bermudan_swaption_pde(t, atm, torch.tensor(SCHED), **kw)
    assert got[0].shape == () and got[2].shape == (33,)
    for g, w in zip(got, want):
        _close(g, w)


def test_ladder_is_one_march_of_the_reference_s_per_strike_marches(hw, atm):
    j, t = hw
    ks = np.linspace(0.6, 1.4, 5) * atm
    plan = jb._march_plan(jnp.asarray(BENCH_SCHED), (True,) * 10, 4, jnp.float64)
    want = jax.vmap(lambda k: jb._bermudan_pde_impl(
        j, k, jnp.asarray(BENCH_SCHED), *plan[:4], payer=True, n_x=33, last=plan[4],
        exercise=(True,) * 10))(jnp.asarray(ks))
    got = tb.bermudan_swaption_pde(t, torch.tensor(ks), torch.tensor(BENCH_SCHED), n_x=33,
                                   n_sub=4)
    assert got[0].shape == (5,) and got[2].shape == (5, 33)
    _close(got[0], want[0])
    _close(got[1], want[1][0])
    _close(got[2], want[2])


def test_kernel_branch_on_the_cpu_twin(monkeypatch, hw, atm):
    """The card's route, forced on the CPU: float32, one thomas_batched
    call a step on the whole ladder, bands shared at batch stride 0."""
    _, t = hw
    t32 = interop.hull_white_params(hw[0], dtype=torch.float32)
    ks = torch.tensor(np.linspace(0.6, 1.4, 6) * atm, dtype=torch.float32)
    sched = torch.tensor(BENCH_SCHED, dtype=torch.float32)
    plain = tb.bermudan_swaption_pde(t32, ks, sched, n_x=33, n_sub=16)
    f64 = tb.bermudan_swaption_pde(t, ks.double(), torch.tensor(BENCH_SCHED), n_x=33,
                                   n_sub=16)
    calls, strides = [], set()
    real = tridiag.thomas_batched

    def spy(lower, diag, upper, rhs):
        calls.append(rhs.shape)
        strides.update((lower.stride(0), diag.stride(0), upper.stride(0)))
        return real(lower, diag, upper, rhs)

    monkeypatch.setattr(tb, "kernel_route", lambda *ts: True)
    monkeypatch.setattr(tridiag, "thomas_batched", spy)
    routed = tb.bermudan_swaption_pde(t32, ks, sched, n_x=33, n_sub=16)
    assert len(calls) == 160 and set(calls) == {(6, 33)} and strides == {0}
    _close(routed[2], plain[2].numpy(), rtol=2e-5, atol=1e-9)
    _close(routed[0], plain[0].numpy(), rtol=2e-5, atol=0.0)
    _close(routed[0], f64[0].numpy(), rtol=1e-4, atol=0.0)


def test_simulate_events_matches_reference(hw):
    j, t = hw
    key = jax.random.PRNGKey(3)
    idx = (0, 2, 3, 6)
    want = jb._simulate_events(j, jnp.asarray(SCHED), jnp.asarray(idx), 1024, key, jnp.float64)
    got = tb._simulate_events(t, torch.tensor(SCHED), idx, 1024, JaxKey(key), F64)
    for g, w in zip(got, want):
        assert g.shape == (4, 1024)
        _close(g, w)


def test_mc_sandwich_matches_reference(hw):
    """A receiver on 1.0 to 3.0 by 0.5 with a gap in its exercise dates (the
    reference compiles its nested continuation loops whole: ~12 s at four
    dates, ~45 s at eight)."""
    j, t = hw
    key = jax.random.PRNGKey(1)
    sched = np.arange(1.0, 3.01, 0.5)
    kw = dict(n_paths=2048, n_outer=32, n_inner=8, payer=False,
              exercise=(True, False, True, True))
    want = jb.bermudan_swaption_mc(j, 0.033, jnp.asarray(sched), key, **kw)
    got = tb.bermudan_swaption_mc(t, 0.033, torch.tensor(sched), JaxKey(key), **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_joint_moments_reproduce_the_curve(hw):
    _, t = hw
    for T in (0.5, 2.0, 10.0):
        v_y = tb.hw_joint_increment_moments(t, T)[3]
        A = tb.hw_alpha_integral(t, 0.0, T)
        assert abs(float(-A + 0.5 * v_y) - float(torch.log(t.curve.df(T)))) < 1e-12


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_european_collapse_of_both_routes(hw, atm):
    _, t = hw
    sched = torch.tensor(SCHED)
    euro = float(trates.hw_swaption(t, atm, 1.0, sched[1:]))
    ex = (True,) + (False,) * 7
    price = float(tb.bermudan_swaption_pde(t, atm, sched, exercise=ex, n_x=401, n_sub=24)[0])
    assert abs(price - euro) / euro < 2e-3
    lo, sel, up, seu = (float(v) for v in tb.bermudan_swaption_mc(
        t, atm, sched, _gen(0), exercise=ex, n_paths=1 << 12, n_outer=64, n_inner=8))
    assert abs(lo - euro) < 4 * sel + 1e-4
    assert abs(up - euro) < 4 * (seu + sel) + 1e-4
    assert abs(up - lo) < 1e-12


def test_pde_inside_the_sandwich_and_orderings(hw, atm):
    _, t = hw
    sched = torch.tensor(SCHED)
    p = float(tb.bermudan_swaption_pde(t, atm, sched, n_x=101, n_sub=8)[0])
    lo, sel, up, seu = (float(v) for v in tb.bermudan_swaption_mc(
        t, atm, sched, _gen(1), n_paths=1 << 12, n_outer=128, n_inner=16))
    assert lo - 4 * sel - 1e-4 <= p <= up + 4 * seu + 1e-4
    assert up - lo < 0.25 * p
    euros = [float(trates.hw_swaption(t, atm, float(sched[j]), sched[j + 1:]))
             for j in range(len(SCHED) - 1)]
    assert p >= max(euros) - 2e-4
    p1 = float(tb.bermudan_swaption_pde(t, atm, sched, exercise=(True,) + (False,) * 7,
                                        n_x=101, n_sub=8)[0])
    assert p >= p1 - 1e-6
    payer = float(tb.bermudan_swaption_pde(t, 0.005, sched, n_x=101, n_sub=8)[0])
    receiver = float(tb.bermudan_swaption_pde(t, 0.005, sched, payer=False, n_x=101,
                                              n_sub=8)[0])
    assert payer > 0.05 and receiver < 5e-3
