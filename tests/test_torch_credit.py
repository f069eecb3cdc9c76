"""``pde_tpu_torch.models.credit`` held against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU:
the legs and par spreads at 1e-12, the bootstrap's hazards at 1e-10 and
its gradient in the spreads against ``jax.jacrev`` at 1e-8 (the port's
Newton slope is the legs' closed form, the reference's a nested
``jax.grad``; the hazards stay differentiable through every trip in
both), the swap CVA against the reference compiled at 1e-10 (see
``tests/test_torch_rates.py``).  The JAX suite's pins are kept (credit
triangle, zero value at par, exact repricing, flat spreads give a flat
hazard, CVA ordering).  The netting-set Monte Carlo waits for the port of
``solvers/bermudan_hw.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.models import credit as jc
from pde_tpu.models import rates as jr
from pde_tpu_torch import interop
from pde_tpu_torch.models import credit as tc
from pde_tpu_torch.models import rates as tr

PILLARS = [1.0, 3.0, 5.0, 7.0, 10.0]
SPREADS = [0.008, 0.011, 0.013, 0.014, 0.015]


def _t(x):
    return interop.tensor(x)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def curves():
    t = np.array([0.5, 1.0, 2.0, 5.0, 10.0, 30.0])
    z = np.array([0.030, 0.032, 0.035, 0.040, 0.042, 0.043])
    return jr.curve_from_zero_rates(t, z), tr.curve_from_zero_rates(_t(t), _t(z))


@pytest.mark.parametrize("maturity,n_buckets", [(5.0, 200), (0.7, 3)])
def test_default_buckets_match_reference(maturity, n_buckets):
    got = tc._default_buckets(maturity, n_buckets, torch.float64, "cpu")
    _close(got, jc._default_buckets(maturity, n_buckets, jnp.float64), 1e-15, 1e-15)


def test_hazard_curve_matches_reference():
    for lam in (0.005, 0.03):
        jh, th = jc.flat_hazard(lam), tc.flat_hazard(_t(lam))
        _close(th.times, jh.times, 0.0)
        _close(th.survival, jh.survival, 1e-15)
        ts = np.linspace(0.1, 60.0, 25)
        _close(th.q(_t(ts)), jh.q(ts), 1e-14)
        _close(th.hazard(_t([1.0, 5.0, 15.0])), np.full(3, lam), 1e-6)
    q = tc.flat_hazard(_t(0.03)).q(_t(np.linspace(0.1, 20.0, 50))).numpy()
    assert np.all(np.diff(q) < 0) and np.all(q > 0) and q[0] < 1.0


@pytest.mark.parametrize("maturity,freq,n_buckets", [(5.0, 0.25, 200), (4.9, 0.25, 200),
                                                     (0.2, 0.25, 16), (2.0, 0.5, 40)])
def test_cds_legs_and_par_spreads_match_reference(curves, maturity, freq, n_buckets):
    """Including a maturity off the payment grid (4.9y) and one short of a
    period (a single payment)."""
    jcur, tcur = curves
    jh, th = jc.flat_hazard(0.02), tc.flat_hazard(_t(0.02))
    kw = dict(recovery=0.35, freq=freq, n_buckets=n_buckets)
    for a, b in zip(tc.cds_legs(tcur, th, maturity, **kw), jc.cds_legs(jcur, jh, maturity, **kw)):
        _close(a, b, 1e-13)
    _close(tc.cds_par_spread(tcur, th, maturity, **kw), jc.cds_par_spread(jcur, jh, maturity, **kw),
           1e-13)


def test_par_spread_strip_value_and_credit_triangle(curves):
    jcur, tcur = curves
    th = tc.flat_hazard(_t(0.02))
    mats = [1.0, 3.0, 5.0, 10.0]
    strip = tc.cds_par_spreads(tcur, th, mats)
    _close(strip, jc.cds_par_spreads(jcur, jc.flat_hazard(0.02), mats), 1e-13)
    _close(strip, [float(tc.cds_par_spread(tcur, th, m)) for m in mats], 1e-15)
    s_par = tc.cds_par_spread(tcur, th, 5.0)
    assert abs(float(tc.cds_value(tcur, th, 5.0, s_par))) < 1e-14
    assert float(tc.cds_value(tcur, th, 5.0, 0.5 * s_par)) > 0
    _close(tc.cds_value(tcur, th, 5.0, 0.01, notional=3.0),
           jc.cds_value(jcur, jc.flat_hazard(0.02), 5.0, 0.01, notional=3.0), 1e-12)
    for lam in (0.005, 0.02, 0.08):
        s = float(tc.cds_par_spread(tcur, tc.flat_hazard(_t(lam)), 5.0, recovery=0.4))
        assert abs(s / (0.6 * lam) - 1.0) < 0.02


def test_bootstrap_matches_reference_and_reprices_exactly(curves):
    jcur, tcur = curves
    hc, hs = tc.bootstrap_hazard(tcur, PILLARS, _t(SPREADS))
    jhc, jhs = jc.bootstrap_hazard(jcur, jnp.asarray(PILLARS), jnp.asarray(SPREADS))
    _close(hs, jhs, 1e-10)
    _close(hc.times, jhc.times, 0.0)
    _close(hc.survival, jhc.survival, 1e-12)
    assert np.all(hs.numpy() > 0)
    _close(tc.cds_par_spreads(tcur, hc, PILLARS), SPREADS, 1e-10)
    # other conventions, and recovery/pillars as tensors
    kw = dict(recovery=0.25, freq=0.5, n_buckets=60, n_newton=8)
    _, hs2 = tc.bootstrap_hazard(tcur, _t(PILLARS[:3]), _t(SPREADS[:3]), **kw)
    _, jhs2 = jc.bootstrap_hazard(jcur, jnp.asarray(PILLARS[:3]), jnp.asarray(SPREADS[:3]), **kw)
    _close(hs2, jhs2, 1e-10)


def test_bootstrap_gradient_in_the_spreads_matches_jax_grad(curves):
    """The hazards stay differentiable in the spreads through every Newton
    trip: d h / d s of every pillar against ``jax.jacrev``."""
    jcur, tcur = curves
    s = _t(SPREADS).requires_grad_()
    _, hs = tc.bootstrap_hazard(tcur, PILLARS, s)
    ref = jax.jacrev(lambda v: jc.bootstrap_hazard(jcur, jnp.asarray(PILLARS), v)[1])(
        jnp.asarray(SPREADS))
    for i in range(len(PILLARS)):
        grad, = torch.autograd.grad(hs[i], s, retain_graph=True)
        _close(grad, ref[i], 1e-8, 1e-12)
        assert float(grad[i]) > 0  # a wider spread, a higher hazard on its pillar


def test_bootstrap_of_flat_spreads_gives_a_flat_hazard(curves):
    _, tcur = curves
    pillars = [2.0, 5.0, 10.0]
    flat = tc.flat_hazard(_t(0.025))
    spreads = torch.stack([tc.cds_par_spread(tcur, flat, t) for t in pillars])
    _, hs = tc.bootstrap_hazard(tcur, pillars, spreads)
    _close(hs, np.full(3, 0.025), 2e-3)


def test_cva_swap_hw_matches_compiled_reference(curves):
    jcur, tcur = curves
    jhw = jr.HullWhiteParams(jnp.asarray(0.1), jnp.asarray(0.012), jcur)
    thw = tr.HullWhiteParams(_t(0.1), _t(0.012), tcur)
    sched = np.arange(0.5, 5.01, 0.5)
    K = float(tr.hw_swap_rate(tcur, 0.5, _t(sched[1:])))
    for lam, payer in ((0.005, True), (0.05, False)):
        got = tc.cva_swap_hw(thw, tc.flat_hazard(_t(lam)), K, _t(sched), recovery=0.3,
                             payer=payer, notional=2.0)
        want = jax.jit(lambda: jc.cva_swap_hw(jhw, jc.flat_hazard(lam), K, sched, recovery=0.3,
                                              payer=payer, notional=2.0))()
        _close(got, want, 1e-10)
    lo = float(tc.cva_swap_hw(thw, tc.flat_hazard(_t(0.005)), K, _t(sched)))
    hi = float(tc.cva_swap_hw(thw, tc.flat_hazard(_t(0.05)), K, _t(sched)))
    assert 0 < lo < hi
    assert float(tc.cva_swap_hw(thw, tc.flat_hazard(_t(1e-12)), K, _t(sched))) < 1e-12


def test_swap_trade_is_a_plain_record():
    trade = tc.SwapTrade(_t(0.04), _t(-1.0), _t(0.4))
    assert trade._fields == jc.SwapTrade._fields
    assert float(trade.payer_sign) == -1.0
