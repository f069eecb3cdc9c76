"""``pde_tpu_torch.models.g2`` held against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU:
the closed forms at 1e-12, the Gauss-Hermite swaption (its node-vectorized
Newton) at 1e-10 against the reference compiled (``jax.jit``; see
``tests/test_torch_rates.py`` for why), the exact simulation core on JAX's
own draws at 1e-12.  The JAX suite's identities are kept (curve
reproduction, the exact martingale identity, ZCB parity, the one-payment
swaption as a ZCB put, payer-receiver parity, the Hull-White limit).  The
Bermudan cases wait for the port of ``solvers/bermudan_g2.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.models import g2 as jg2
from pde_tpu.models import rates as jr
from pde_tpu_torch import interop
from pde_tpu_torch.models import g2 as tg2
from pde_tpu_torch.models import rates as tr

TIMES = np.array([0.5, 1.0, 2.0, 5.0, 10.0, 30.0])
ZEROS = np.array([0.030, 0.032, 0.035, 0.040, 0.042, 0.043])
DYN = (0.5, 0.05, 0.01, 0.008, -0.6)


def _t(x):
    return interop.tensor(x)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def params():
    jc = jr.curve_from_zero_rates(TIMES, ZEROS)
    jp = jg2.G2Params(*map(jnp.asarray, DYN), jc).validate()
    return jp, interop.g2_params(jp).validate()


def test_bond_and_variance_match_reference(params):
    jp, tp = params
    ts = np.array([0.5, 1.0, 7.3, 25.0])
    _close(tg2.g2_bond(tp, _t(ts)), tp.curve.df(_t(ts)), 1e-14)
    x, y = np.array([-0.02, 0.0, 0.015]), np.array([0.01, -0.005, 0.0])
    _close(tg2.g2_bond(tp, _t(ts + 1.0)[:, None], 1.0, _t(x), _t(y)),
           jg2.g2_bond(jp, (ts + 1.0)[:, None], 1.0, x, y), 1e-12)
    _close(tg2._v_func(tp, _t(ts)), jg2._v_func(jp, ts), 1e-12)
    _close(tg2._sigma_p(tp, 1.0, _t(ts + 1.0)), jg2._sigma_p(jp, 1.0, ts + 1.0), 1e-12)
    for a, b in zip(tg2._forward_measure_moments(tp, _t([0.5, 2.0, 9.0])),
                    jg2._forward_measure_moments(jp, np.array([0.5, 2.0, 9.0]))):
        _close(a, b, 1e-12)
    with pytest.raises(ValueError):
        tg2.G2Params(0.5, 0.05, 0.01, 0.008, 1.5, tp.curve).validate()


def test_zcb_options_caplets_and_caps_match_reference(params):
    jp, tp = params
    for is_call in (True, False):
        _close(tg2.g2_zcb_option(tp, _t([0.85, 0.9]), 1.0, 3.0, is_call),
               jg2.g2_zcb_option(jp, np.array([0.85, 0.9]), 1.0, 3.0, is_call), 1e-12)
    call = float(tg2.g2_zcb_option(tp, 0.9, 1.0, 3.0, is_call=True))
    put = float(tg2.g2_zcb_option(tp, 0.9, 1.0, 3.0, is_call=False))
    assert abs(call - put - (float(tp.curve.df(3.0)) - 0.9 * float(tp.curve.df(1.0)))) < 1e-14
    ks = np.array([0.01, 0.03, 0.05, 0.08])
    caplets = tg2.g2_caplet(tp, _t(ks), 1.0, 1.5)
    _close(caplets, jg2.g2_caplet(jp, ks, 1.0, 1.5), 1e-12)
    assert np.all(np.diff(caplets.numpy()) < 0) and np.all(caplets.numpy() > 0)
    pay = np.array([1.0, 1.5, 2.0, 3.0])
    _close(tg2.g2_cap(tp, 0.035, _t(pay)), jg2.g2_cap(jp, 0.035, pay), 1e-12)


@pytest.mark.parametrize("payer", [True, False])
def test_swaption_matches_compiled_reference(params, payer):
    jp, tp = params
    pay = np.arange(1.5, 5.01, 0.5)
    for K in (0.03, 0.038, 0.05):
        _close(tg2.g2_swaption(tp, K, 1.0, _t(pay), payer=payer, notional=2.0),
               jax.jit(lambda: jg2.g2_swaption(jp, K, 1.0, pay, payer=payer, notional=2.0))(),
               1e-10)
    _close(tg2.g2_swaption(tp, 0.04, 2.0, _t(pay + 1.0), payer=payer, n_gh=16, n_newton=8),
           jax.jit(lambda: jg2.g2_swaption(jp, 0.04, 2.0, pay + 1.0, payer=payer, n_gh=16,
                                           n_newton=8))(), 1e-10)


def test_swaption_identities(params):
    jp, tp = params
    # one fixed payment: the swaption IS a ZCB put
    K, T0, T1 = 0.04, 1.0, 2.0
    sw = float(tg2.g2_swaption(tp, K, T0, _t([T1])))
    rep = float((1.0 + K) * tg2.g2_zcb_option(tp, 1.0 / (1.0 + K), T0, T1, is_call=False))
    assert abs(sw / rep - 1.0) < 1e-10
    # payer - receiver = forward swap value
    sched = np.arange(1.0, 5.01, 0.5)
    pp = float(tg2.g2_swaption(tp, 0.035, 1.0, _t(sched[1:])))
    rr = float(tg2.g2_swaption(tp, 0.035, 1.0, _t(sched[1:]), payer=False))
    c = np.diff(sched) * 0.035
    c[-1] += 1.0
    fwd = float(tp.curve.df(1.0)) - float(torch.sum(_t(c) * tp.curve.df(_t(sched[1:]))))
    assert abs((pp - rr) - fwd) < 1e-12


def test_swaption_hw_limit(params):
    """eta -> 0 reduces G2++ to Hull-White(a, sigma) (256 nodes, 2e-3)."""
    curve = params[1].curve
    pay = _t(np.arange(1.5, 5.01, 0.5))
    K = tr.hw_swap_rate(curve, 1.0, pay)
    deg = tg2.G2Params(_t(0.1), _t(1.0), _t(0.012), _t(1e-6), _t(0.0), curve)
    hw = tr.HullWhiteParams(_t(0.1), _t(0.012), curve)
    assert abs(float(tg2.g2_swaption(deg, K, 1.0, pay, n_gh=256))
               / float(tr.hw_swaption(hw, K, 1.0, pay)) - 1.0) < 2e-3


def test_swaption_panel_broadcast_matches_reference_vmap(params):
    """Expiries (M,) into pay dates (M, n) in one call against the
    reference's ``vmap`` (bench_full.py:497-505)."""
    jp, tp = params
    ex = np.linspace(0.5, 10.0, 6)
    rel = np.arange(0.5, 5.01, 0.5)

    def one(e):
        pt = e + rel
        return jg2.g2_swaption(jp, jr.hw_swap_rate(jp.curve, e, pt), e, pt, n_gh=32)

    par = tr.hw_swap_rate(tp.curve, _t(ex), _t(ex[:, None] + rel))
    _close(tg2.g2_swaption(tp, par, _t(ex), _t(ex[:, None] + rel), n_gh=32),
           jax.jit(jax.vmap(one))(ex), 1e-10)


def test_swaption_jacobian_matches_jax(params):
    """Forward-mode derivatives through the GH contraction and the
    critical-boundary Newton (the G2 LM's Jacobian) against jax.jacfwd."""
    jp, tp = params
    pay = np.arange(1.5, 4.01, 0.5)

    def port(v):
        return tg2.g2_swaption(tg2.G2Params(*v.unbind(0), tp.curve), 0.035, 1.0, _t(pay),
                               n_gh=32)

    def ref(v):
        return jg2.g2_swaption(jg2.G2Params(*v, jp.curve), 0.035, 1.0, pay, n_gh=32)

    _close(torch.func.jacfwd(port)(_t(DYN)), jax.jit(jax.jacfwd(ref))(jnp.asarray(DYN)), 1e-8,
           1e-12)


def test_phi_integral_and_increment_moments_match_reference(params):
    jp, tp = params
    t1, t2 = np.array([0.0, 1.0, 3.0]), np.array([0.7, 4.0, 12.0])
    _close(tg2.g2_phi_integral(tp, _t(t1), _t(t2)),
           jax.jit(lambda: jg2.g2_phi_integral(jp, t1, t2))(), 1e-12)
    for T in (0.7, 3.0, 12.0):
        (means, cov), (jmeans, jcov) = (tg2.g2_joint_increment_moments(tp, T),
                                        jg2.g2_joint_increment_moments(jp, T))
        for a, b in zip(means, jmeans):
            _close(a, b, 1e-13)
        _close(cov, jcov, 1e-11)
        # the exact martingale identity: -int phi + Var(S)/2 = log P(0, T)
        A = tg2.g2_phi_integral(tp, 0.0, T)
        assert abs(float(-A + 0.5 * cov[2, 2]) - float(torch.log(tp.curve.df(T)))) < 1e-12
    # a vector of steps gives (n, 3, 3)
    _, covs = tg2.g2_joint_increment_moments(tp, _t([0.5, 1.0]))
    assert covs.shape == (2, 3, 3)


def test_simulate_core_on_jax_draws_matches_reference(params):
    jp, tp = params
    ts = np.array([0.0, 0.5, 1.0, 2.5, 5.0])
    key, n_paths = jax.random.PRNGKey(3), 128
    ref = jg2._g2_simulate_core(jp, jnp.asarray(ts), key, n_paths)
    keys = jax.random.split(key, len(ts) - 1)
    z = np.stack([np.asarray(jax.random.normal(k, (3, n_paths), jnp.float64)) for k in keys])
    # the step covariance cancels (Var S ~ b dt^3 / 3 from terms ~dt), so
    # its entries agree to ~2e-13 relative; a path value near 0 (a sum of
    # ~0.05 terms) is held at 1e-13 absolute
    for a, b in zip(tg2._g2_simulate_core(tp, _t(ts), _t(z)), ref):
        _close(a, b, 1e-12, 1e-13)


def test_simulate_discounts_reproduce_the_curve(params):
    """mean(e^{log D}) -> P(0, T) on the port's own draws, on the curve's
    device."""
    _, tp = params
    xs, ys, logds = tg2.g2_simulate(tp, _t([1.0, 5.0]), torch.Generator().manual_seed(0),
                                    n_paths=1 << 14)
    assert xs.shape == ys.shape == logds.shape == (2, 1 << 14)
    for j, T in enumerate([1.0, 5.0]):
        d = torch.exp(logds[j])
        se = float(d.std()) / np.sqrt(d.numel())
        assert abs(float(d.mean()) - float(tp.curve.df(T))) < 5 * se
