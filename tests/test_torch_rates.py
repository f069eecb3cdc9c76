"""``pde_tpu_torch.models.rates`` held against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU:
closed forms at 1e-12, the Newton-based prices (Jamshidian swaptions, the
caplet strip, the Bachelier inversion) at 1e-10, the simulation core on
JAX's own draws at 1e-12.

The reference's Newton prices are compared under ``jax.jit``.  XLA folds
``log(exp(x))`` to ``x`` when it compiles, so the reference's compiled
curve reads (its ``lax.scan`` Newton, its jitted fits) take the
instantaneous forward from the log-discounts directly, while its eager
calls round through ``exp`` and ``log``: the symmetric difference over
2e-5 magnifies that rounding to ~1e-12 in the forward and ~1e-10 in an
ATM swaption.  The port reads the log-discounts as the compiled reference
does, and matches it to the bit.  The JAX suite's own pins (parity, curve
reproduction, strip exactness) are kept.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.models import credit as jcredit
from pde_tpu.models import g2 as jg2
from pde_tpu.models import rates as jr
from pde_tpu_torch import interop
from pde_tpu_torch.models import credit as tcredit
from pde_tpu_torch.models import g2 as tg2
from pde_tpu_torch.models import rates as tr

TIMES = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 30.0])
ZEROS = np.array([0.030, 0.032, 0.035, 0.037, 0.040, 0.042, 0.043])
READS = np.array([-0.5, 0.0, 1e-6, 0.3, 0.5, 0.75, 1.0, 1.5, 3.0, 7.3, 29.0, 30.0, 45.0])


def _t(x):
    return interop.tensor(x)


@pytest.fixture(scope="module")
def curves():
    return jr.curve_from_zero_rates(TIMES, ZEROS), tr.curve_from_zero_rates(_t(TIMES), _t(ZEROS))


@pytest.fixture(scope="module")
def hw(curves):
    jc, tc = curves
    return (jr.HullWhiteParams(jnp.asarray(0.10), jnp.asarray(0.012), jc),
            tr.HullWhiteParams(_t(0.10), _t(0.012), tc))


VAS = (0.5, 0.04, 0.015, 0.03)
CIR = (0.5, 0.04, 0.1, 0.03)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), rtol=rtol, atol=atol)


# -- curve ------------------------------------------------------------------

def test_curve_reads_match_reference(curves):
    """df, zero rates and forwards at pillars, between them, below 0 (the
    clamp) and past the last pillar (flat-forward extrapolation)."""
    jc, tc = curves
    _close(tc.df(_t(READS)), jc.df(READS), 1e-14)
    pos = READS[READS > 0]
    _close(tc.zero_rate(_t(pos)), jc.zero_rate(pos), 1e-13)
    _close(tc.forward(_t(pos), _t(pos + 0.5)), jc.forward(pos, pos + 0.5), 1e-12)
    # the symmetric difference over 2e-5 turns one ulp of log P (|log P|
    # <= 2 here) into 2.2e-11 of the forward, in either package and in
    # both of the reference's forms (module docstring)
    for ref in (jax.jit(jc.inst_forward)(READS), jc.inst_forward(READS)):
        _close(tc.inst_forward(_t(READS)), ref, 0.0, 1e-10)
    # the JAX suite's pins
    _close(tc.df(tc.times), tc.dfs, 1e-12)
    assert abs(float(tc.forward(1.0, 2.0)) - (float(tc.df(1.0) / tc.df(2.0)) - 1.0)) < 1e-12
    seg = float(-(torch.log(tc.df(2.0)) - torch.log(tc.df(1.0))))
    assert abs(float(tc.inst_forward(1.5)) - seg) < 1e-6


def test_flat_curve_and_zero_rate_curve_match_reference():
    for rate in (0.05, 0.0):
        jc, tc = jr.flat_curve(rate), tr.flat_curve(_t(rate))
        _close(tc.times, jc.times, 0.0)
        _close(tc.dfs, jc.dfs, 1e-15)
        for t in (0.1, 1.0, 7.3, 49.0, 60.0):
            assert abs(float(tc.df(t)) - np.exp(-rate * t)) < 1e-12
    jc = jr.flat_curve(0.03, horizon=20.0, n=5)
    tc = tr.flat_curve(_t(0.03), horizon=20.0, n=5)
    _close(tc.times, jc.times, 0.0)
    assert tc.times.dtype == torch.float64 and tc.times.device.type == "cpu"


# -- Vasicek / CIR ----------------------------------------------------------

def test_vasicek_matches_reference():
    jp, tp = jr.VasicekParams(*map(jnp.asarray, VAS)), tr.VasicekParams(*map(_t, VAS))
    T = np.array([0.25, 1.0, 3.0, 10.0])
    _close(tr.vasicek_bond(tp, _t(T)), jr.vasicek_bond(jp, T), 1e-13)
    _close(tr.vasicek_bond(tp, _t(T), 0.2, _t(0.05)), jr.vasicek_bond(jp, T, 0.2, 0.05), 1e-13)
    for is_call in (True, False):
        _close(tr.vasicek_bond_option(tp, 0.9, 1.0, _t([2.0, 3.0]), is_call),
               jr.vasicek_bond_option(jp, 0.9, 1.0, np.array([2.0, 3.0]), is_call), 1e-12)
    call = float(tr.vasicek_bond_option(tp, 0.9, 1.0, 3.0, is_call=True))
    put = float(tr.vasicek_bond_option(tp, 0.9, 1.0, 3.0, is_call=False))
    p0, p1 = float(tr.vasicek_bond(tp, 1.0)), float(tr.vasicek_bond(tp, 3.0))
    assert abs((call - put) - (p1 - 0.9 * p0)) < 1e-12
    with pytest.raises(ValueError):
        tr.VasicekParams(0.5, 0.04, -1.0, 0.03).validate()


def test_cir_matches_reference_and_stays_finite_when_stiff():
    jp, tp = jr.CIRParams(*map(jnp.asarray, CIR)), tr.CIRParams(*map(_t, CIR))
    T = np.array([0.5, 1.0, 2.0, 5.0, 10.0])
    _close(tr.cir_bond(tp, _t(T)), jr.cir_bond(jp, T), 1e-13)
    _close(tr.cir_bond(tp, _t(T), 0.5, _t(0.02)), jr.cir_bond(jp, T, 0.5, 0.02), 1e-13)
    assert tp.feller() == jp.feller()
    stiff = tr.CIRParams(_t(500.0), _t(0.04), _t(0.1), _t(0.03))
    assert abs(float(tr.cir_bond(stiff, 2.0)) - np.exp(-0.04 * 2.0)) < 1e-3


def test_affine_b_has_the_zero_mean_reversion_limit():
    tau = np.array([0.0, 0.5, 3.0])
    for a in (0.0, 1e-14, 0.3):
        _close(tr._affine_b(_t(a), _t(tau)), jr._affine_b(jnp.asarray(a), tau), 1e-14)


# -- Hull-White -------------------------------------------------------------

def test_hw_bond_and_options_match_reference(hw):
    jp, tp = hw
    ts = np.array([0.25, 1.0, 4.0, 12.0])
    _close(tr.hw_bond(tp, _t(ts)), tp.curve.df(_t(ts)), 1e-14)
    r = np.array([0.01, 0.03, 0.06])[:, None]
    _close(tr.hw_bond(tp, _t(ts + 1.0), 1.0, _t(r)),
           jax.jit(lambda: jr.hw_bond(jp, ts + 1.0, 1.0, r))(), 1e-12)
    K = np.array([0.85, 0.92, 0.97])
    for is_call in (True, False):
        _close(tr.hw_bond_option(tp, _t(K), 1.0, 3.0, is_call),
               jr.hw_bond_option(jp, K, 1.0, 3.0, is_call), 1e-12)
    starts = np.array([0.5, 1.0, 2.5, 7.0])
    ks = np.array([0.03, 0.04, 0.035, 0.05])
    _close(tr.hw_caplet(tp, _t(ks), _t(starts), _t(starts + 0.5)),
           jr.hw_caplet(jp, ks, starts, starts + 0.5), 1e-12)
    _close(tr.hw_floorlet(tp, _t(ks), _t(starts), _t(starts + 0.5), notional=2.0),
           jr.hw_floorlet(jp, ks, starts, starts + 0.5, notional=2.0), 1e-12)
    pay = np.array([1.0, 1.5, 2.0, 2.5])
    _close(tr.hw_cap(tp, 0.04, _t(pay)), jr.hw_cap(jp, 0.04, pay), 1e-12)
    parts = sum(float(tr.hw_caplet(tp, 0.04, s, e)) for s, e in zip(pay[:-1], pay[1:]))
    assert abs(float(tr.hw_cap(tp, 0.04, _t(pay))) - parts) < 1e-12
    with pytest.raises(ValueError):
        tr.HullWhiteParams(_t(-0.1), _t(0.01), tp.curve).validate()


def test_hw_zero_vol_limit(hw):
    """sigma -> 0: the caplet collapses to the discounted intrinsic."""
    tiny = tr.HullWhiteParams(hw[1].a, _t(1e-8), hw[1].curve)
    f = float(tiny.curve.forward(1.0, 1.5))
    for K in (f - 0.01, f + 0.01):
        intr = float(tiny.curve.df(1.5)) * 0.5 * max(f - K, 0.0)
        assert abs(float(tr.hw_caplet(tiny, K, 1.0, 1.5)) - intr) < 1e-7


@pytest.mark.parametrize("payer", [True, False])
def test_hw_swaption_and_critical_rate_match_compiled_reference(hw, payer):
    jp, tp = hw
    pay = np.arange(1.5, 6.01, 0.5)
    for K in (0.03, 0.04, 0.05):
        _close(tr.hw_swaption(tp, K, 1.0, _t(pay), notional=3.0, payer=payer),
               jax.jit(lambda: jr.hw_swaption(jp, K, 1.0, pay, notional=3.0, payer=payer))(),
               1e-10)
    taus = np.diff(np.concatenate([[1.0], pay]))
    c = taus * 0.04
    c[-1] += 1.0
    _close(tr._hw_critical_rate(tp, 1.0, _t(pay), _t(c)),
           jr._hw_critical_rate(jp, jnp.asarray(1.0), jnp.asarray(pay), jnp.asarray(c)), 1e-10)


def test_hw_swap_rate_and_panel_broadcast_match_reference_vmap(hw):
    """A panel (expiries (M,), pay dates (M, n)) in one call against the
    reference's ``vmap`` over expiries (bench_full.py:435-441)."""
    jp, tp = hw
    ex = np.linspace(0.5, 10.0, 9)
    rel = np.arange(0.5, 5.01, 0.5)
    pay = ex[:, None] + rel

    def one(e):
        pt = e + rel
        return jr.hw_swaption(jp, jr.hw_swap_rate(jp.curve, e, pt), e, pt)

    par = tr.hw_swap_rate(tp.curve, _t(ex), _t(pay))
    _close(par, jax.vmap(lambda e: jr.hw_swap_rate(jp.curve, e, e + rel))(ex), 1e-13)
    _close(tr.hw_swaption(tp, par, _t(ex), _t(pay)), jax.jit(jax.vmap(one))(ex), 1e-10)
    # payer == receiver at the par strike
    pt = _t([1.5, 2.0, 2.5, 3.0])
    k = tr.hw_swap_rate(tp.curve, 1.0, pt)
    assert abs(float(tr.hw_swaption(tp, k, 1.0, pt)
                     - tr.hw_swaption(tp, k, 1.0, pt, payer=False))) < 1e-10


def test_hw_swaption_jacobian_matches_jax(hw):
    """Forward-mode derivatives through the Jamshidian Newton (the LM's
    Jacobian) against ``jax.jacfwd``."""
    jp, tp = hw
    pay = np.arange(1.5, 4.01, 0.5)

    def port(x):
        return tr.hw_swaption(tr.HullWhiteParams(x[0], x[1], tp.curve), 0.035, 1.0, _t(pay))

    def ref(x):
        return jr.hw_swaption(jr.HullWhiteParams(x[0], x[1], jp.curve), 0.035, 1.0, pay)

    _close(torch.func.jacfwd(port)(_t([0.1, 0.012])),
           jax.jit(jax.jacfwd(ref))(jnp.asarray([0.1, 0.012])), 1e-8)


def test_hw_alpha_matches_reference(hw):
    jp, tp = hw
    ts = np.linspace(0.0, 4.0, 17)
    # alpha carries the forward's symmetric difference (its 1e-10 above)
    _close(tr.hw_alpha(tp, _t(ts)), jax.jit(lambda: jr.hw_alpha(jp, ts))(), 0.0, 1e-10)


def _jax_normals(key, shape_per_step, n_steps):
    """The normals the reference's scan draws: one key a step."""
    keys = jax.random.split(key, n_steps)
    return np.stack([np.asarray(jax.random.normal(k, shape_per_step, jnp.float64))
                     for k in keys])


def test_hw_simulate_core_on_jax_draws_matches_reference(hw):
    jp, _ = hw
    n_steps, n_paths, T = 24, 64, 2.0
    key = jax.random.PRNGKey(7)
    ts = np.linspace(0.0, T, n_steps + 1)
    alphas = np.asarray(jr.hw_alpha(jp, ts))
    r_ref, int_ref = jr._hw_simulate_core(jnp.asarray(0.1), jnp.asarray(0.012),
                                          jnp.asarray(alphas)[:, None], T / n_steps, n_paths,
                                          key, jnp.float64)
    z = _jax_normals(key, (n_paths,), n_steps)
    r, integ = tr._hw_simulate_core(_t(0.1), _t(0.012), _t(alphas), T / n_steps, _t(z))
    _close(r, r_ref, 1e-12)
    _close(integ, int_ref, 1e-12)


def test_hw_simulate_reproduces_the_curve(hw):
    """E[e^{-int r}] = P(0, T) on the port's own draws (the JAX suite's
    martingale pin), on the curve's device."""
    _, tp = hw
    gen = torch.Generator().manual_seed(3)
    r_path, int_r = tr.hw_simulate(tp, 3.0, gen, n_steps=96, n_paths=1 << 14)
    assert r_path.shape == (96, 1 << 14) and r_path.device.type == "cpu"
    disc = torch.exp(-int_r)
    se = float(disc.std()) / np.sqrt(disc.numel())
    assert abs(float(disc.mean()) - float(tp.curve.df(3.0))) < 4 * se + 5e-5


# -- Bachelier / Black ------------------------------------------------------

def test_bachelier_price_and_inversion_match_reference():
    f, T, ann = 0.03, 2.0, 4.2
    ks = np.array([0.01, 0.025, 0.03, 0.035, 0.06])
    for is_call in (True, False):
        p = tr.bachelier_price(f, _t(ks), 0.0075, T, ann, is_call)
        _close(p, jr.bachelier_price(f, ks, 0.0075, T, ann, is_call), 1e-13)
        iv = tr.bachelier_implied_vol(p, f, _t(ks), T, ann, is_call)
        _close(iv, jr.bachelier_implied_vol(np.asarray(p), f, ks, T, ann, is_call), 1e-10)
        _close(iv, np.full(5, 0.0075), 0.0, 1e-8)
    flags = np.array([True, False, True, False, True])
    p = tr.bachelier_price(f, _t(ks), 0.0075, T, 1.0, torch.as_tensor(flags))
    _close(p, jr.bachelier_price(f, ks, 0.0075, T, 1.0, flags), 1e-13)


def test_bachelier_quotes_a_hw_swaption():
    """The JAX suite's pin: a Jamshidian swaption's normal vol reprices it."""
    curve = tr.curve_from_zero_rates(_t([1.0, 5.0, 10.0]), _t([0.03, 0.04, 0.042]))
    p = tr.HullWhiteParams(_t(0.1), _t(0.012), curve)
    pay = _t(np.arange(1.5, 4.01, 0.5))
    K = tr.hw_swap_rate(curve, 1.0, pay)
    price = tr.hw_swaption(p, K, 1.0, pay)
    annuity = torch.sum(torch.diff(pay, prepend=_t([1.0])) * curve.df(pay))
    iv = tr.bachelier_implied_vol(price, K, K, 1.0, annuity)
    assert 0.001 < float(iv) < 0.05
    assert abs(float(tr.bachelier_price(K, K, iv, 1.0, annuity) - price)) < 1e-10


@pytest.fixture(scope="module")
def cap_curves():
    t, z = np.array([0.5, 1.0, 2.0, 5.0, 10.0, 30.0]), np.array(
        [0.030, 0.032, 0.035, 0.040, 0.042, 0.043])
    return jr.curve_from_zero_rates(t, z), tr.curve_from_zero_rates(_t(t), _t(z))


def test_black_caplet_and_cap_match_reference(cap_curves):
    jc, tc = cap_curves
    starts = np.array([0.25, 1.0, 2.0, 4.5])
    vols = np.array([0.1, 0.2, 0.3, 0.25])
    _close(tr.black_caplet_price(tc, 0.035, _t(starts), _t(starts + 0.25), _t(vols)),
           jr.black_caplet_price(jc, 0.035, starts, starts + 0.25, vols), 1e-12)
    for m, first in ((2.0, None), (3.0, 0.5)):
        _close(tr.black_cap_price(tc, 0.035, m, 0.2, first_reset=first),
               jr.black_cap_price(jc, 0.035, m, 0.2, first_reset=first), 1e-12)
    lo = float(tr.black_caplet_price(tc, 0.036, 1.0, 1.25, 0.10))
    assert 0.0 < lo < float(tr.black_caplet_price(tc, 0.036, 1.0, 1.25, 0.30))


def test_black_vega_is_the_price_derivative(cap_curves):
    _, tc = cap_curves
    v = _t([0.1, 0.2, 0.35]).requires_grad_()
    price, vega = tr._black_caplet(tc, _t([0.03, 0.035, 0.05]), _t([0.5, 1.0, 3.0]),
                                   _t([0.75, 1.25, 3.25]), v)
    grad, = torch.autograd.grad(price.sum(), v)
    _close(vega, grad, 1e-12)


@pytest.mark.parametrize("vols", [[0.22, 0.22, 0.22, 0.22], [0.26, 0.24, 0.22, 0.20]])
def test_strip_caplet_vols_matches_reference_and_reprices_caps(cap_curves, vols):
    jc, tc = cap_curves
    mats = [1.0, 2.0, 3.0, 5.0]
    starts, ends, fwd = tr.strip_caplet_vols(tc, 0.035, mats, _t(vols))
    js, je, jf = jr.strip_caplet_vols(jc, 0.035, mats, jnp.asarray(vols))
    _close(starts, js, 0.0)
    _close(fwd, jf, 1e-10)
    for m, v in zip(mats, vols):
        mask = starts < m - 1e-9
        stripped = torch.sum(torch.where(
            mask, tr.black_caplet_price(tc, 0.035, starts, ends, fwd), 0.0))
        _close(stripped, tr.black_cap_price(tc, 0.035, m, v), 1e-9)
    if len(set(vols)) == 1:
        _close(fwd, np.full(fwd.shape, vols[0]), 1e-8)


# -- the records cross from JAX -----------------------------------------------

def test_interop_converters_round_trip(hw):
    jp, _ = hw
    g2p = jg2.G2Params(*map(jnp.asarray, (0.5, 0.05, 0.01, 0.008, -0.6)), jp.curve)
    hz = jcredit.flat_hazard(0.02)
    trade = jcredit.SwapTrade(jnp.asarray(0.04), jnp.asarray(-1.0), jnp.asarray(0.7))
    cases = [
        (interop.discount_curve(jp.curve), jp.curve),
        (interop.vasicek_params(jr.VasicekParams(*map(jnp.asarray, VAS))), VAS),
        (interop.cir_params(jr.CIRParams(*map(jnp.asarray, CIR))), CIR),
        (interop.hazard_curve(hz), hz),
        (interop.swap_trade(trade), trade),
    ]
    for port, ref in cases:
        for a, b in zip(port, ref):
            assert isinstance(a, torch.Tensor) and a.dtype == torch.float64
            _close(a, b, 0.0)
    h = interop.hull_white_params(jp)
    g = interop.g2_params(g2p)
    for port, ref in ((h, jp), (g, g2p)):
        assert isinstance(port.curve, tr.DiscountCurve)
        for a, b in zip(port[:-1], ref[:-1]):
            _close(a, b, 0.0)
        _close(port.curve.dfs, ref.curve.dfs, 0.0)
    assert isinstance(g, tg2.G2Params) and isinstance(interop.hazard_curve(hz),
                                                       tcredit.HazardCurve)
    f32 = interop.hull_white_params(jp, dtype=torch.float32)
    assert f32.a.dtype == f32.curve.times.dtype == torch.float32
