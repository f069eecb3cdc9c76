"""The Monte Carlo names of ``pde_tpu_torch.models.multi_asset`` held
against ``pde_tpu`` on the CPU.

Both packages work in float32 here whatever the inputs' dtype (the
reference hard-wires it), so the parity runs in float32 on the reference's
own normals (``jax_key_draws.JaxKey``).  Gates, each with its reason:
- the normals bit-equal, the terminal spots within 4 float32 ulps relative
  (the ``z @ L.T`` product and ``exp`` round in another order);
- prices within 8 float32 ulps relative, standard errors within 8 float32
  ulps of the price: the means and the control regressions sum 4096
  float32 terms in another order (measured: 3.4 ulps for the basket's
  prices), and a standard error is the spread of a residual of terms the
  size of the price, so its rounding is relative to the price (at K = 0
  the Margrabe control IS the payoff and the standard error is rounding
  alone: 1.2e-8 against the reference's 2.5e-7, on a price of 14.9);
- the controls' closed forms run in the inputs' precision (float64 tensors
  here, as the x64 reference computes them in float64);
- a rho = 1 pair: ``jnp.linalg.cholesky`` returns NaN below the diagonal
  in float32 (the 1e-12 jitter vanishes), and so does the port, where
  ``torch.linalg.cholesky`` would raise; in float64 the jitter factorizes
  it, held at 1e-10 absolute (the entry below the tiny pivot is a
  cancellation of O(1e-16) divided by 1.4e-6: it is rounding in both
  factorizations, 3.9e-12 apart);
- the reference suite's statistical checks on the port's own generator
  (Philox): the control estimate inside the raw 4 s.e. and 3x tighter,
  the geometric payoff and spread and rainbow within 4 s.e. of their
  closed forms.
Sizes: at most 4096 paths for parity, 2^16 for the statistical checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey

from pde_tpu.models import multi_asset as jm
from pde_tpu_torch.models import multi_asset as tm

F64 = torch.float64
CPU = torch.device("cpu")
ULP = float(np.finfo(np.float32).eps)
KEY = jax.random.PRNGKey(42)
SPOTS = np.linspace(90.0, 115.0, 8)
W = np.full(8, 0.125)
VOLS = np.linspace(0.18, 0.42, 8)
CORR = 0.45 * np.ones((8, 8)) + 0.55 * np.eye(8)
KS = np.linspace(85.0, 120.0, 16)
PAIR = dict(maturity=0.9, rate=0.03, div1=0.01, div2=0.02)
N = 4096


def _t(a):
    return torch.tensor(a, dtype=F64)


def _prices_close(got, want, ulps=8.0):
    price, se = (np.asarray(g, dtype=np.float64) for g in got)
    w_price, w_se = (np.asarray(w, dtype=np.float64) for w in want)
    assert got[0].dtype == torch.float32 and price.shape == w_price.shape
    scale = ulps * ULP * np.abs(w_price)
    assert np.all(np.abs(price - w_price) <= scale), (price, w_price)
    assert np.all(np.abs(se - w_se) <= scale), (se, w_se)


@pytest.mark.parametrize("antithetic", [True, False])
def test_sample_terminal_gbm_matches_reference(antithetic):
    want_s, want_z = jm.sample_terminal_gbm(KEY, jnp.asarray(SPOTS), jnp.asarray(VOLS),
                                            jnp.asarray(CORR), 0.9, 0.03, 0.01, n_paths=N,
                                            antithetic=antithetic)
    s, z = tm.sample_terminal_gbm(JaxKey(KEY), _t(SPOTS), _t(VOLS), _t(CORR), 0.9, 0.03, 0.01,
                                  n_paths=N, antithetic=antithetic, device=CPU)
    assert s.dtype == torch.float32 and s.shape == (N, 8)
    np.testing.assert_array_equal(z.numpy(), np.asarray(want_z))
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=4 * ULP, atol=0.0)


BASKETS = {
    "ladder_cv": dict(),
    "ladder_raw": dict(control_variate=False),
    "put_ladder_cv": dict(is_call=False),
    "scalar_cv_no_antithetic": dict(strikes=101.5, antithetic=False),
}


@pytest.mark.parametrize("case", sorted(BASKETS))
def test_price_basket_mc_matches_reference(case):
    kw = dict(BASKETS[case])
    strikes = kw.pop("strikes", KS)
    want = jm.price_basket_mc(KEY, jnp.asarray(SPOTS), jnp.asarray(W), jnp.asarray(strikes),
                              0.9, jnp.asarray(VOLS), jnp.asarray(CORR), rate=0.03,
                              dividends=0.01, n_paths=N, **kw)
    got = tm.price_basket_mc(JaxKey(KEY), _t(SPOTS), _t(W), _t(strikes), 0.9, _t(VOLS),
                             _t(CORR), rate=0.03, dividends=0.01, n_paths=N, device=CPU, **kw)
    _prices_close(got, want)


SPREADS = {"cv": dict(), "raw": dict(control_variate=False), "put_cv": dict(is_call=False)}


@pytest.mark.parametrize("case", sorted(SPREADS))
def test_price_spread_mc_matches_reference(case):
    kw = SPREADS[case]
    ks = [-5.0, 0.0, 4.0, 10.0]
    want = jm.price_spread_mc(KEY, 100.0, 96.0, jnp.asarray(ks), vol1=0.25, vol2=0.35,
                              rho=0.4, n_paths=N, **PAIR, **kw)
    got = tm.price_spread_mc(JaxKey(KEY), _t(100.0), _t(96.0), _t(ks), vol1=_t(0.25),
                             vol2=_t(0.35), rho=_t(0.4), n_paths=N, device=CPU, **PAIR, **kw)
    _prices_close(got, want)


@pytest.mark.parametrize("kind", ["call_on_max", "call_on_min", "put_on_max", "put_on_min"])
def test_price_rainbow_mc_matches_reference(kind):
    want = jm.price_rainbow_mc(KEY, 100.0, 96.0, jnp.asarray([90.0, 100.0, 110.0]),
                               vol1=0.25, vol2=0.35, rho=0.4, kind=kind, n_paths=N, **PAIR)
    got = tm.price_rainbow_mc(JaxKey(KEY), _t(100.0), _t(96.0), _t([90.0, 100.0, 110.0]),
                              vol1=_t(0.25), vol2=_t(0.35), rho=_t(0.4), kind=kind, n_paths=N,
                              device=CPU, **PAIR)
    _prices_close(got, want)


def test_rho_one_pair_is_nan_in_float32_as_the_reference():
    corr = np.array([[1.0, 1.0, 0.2], [1.0, 1.0, 0.2], [0.2, 0.2, 1.0]])
    want = np.asarray(jm._chol_corr(jnp.asarray(corr, jnp.float32)))
    got = tm._chol_corr(torch.tensor(corr, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(want, 1))
    assert np.isnan(got[np.tril_indices(3)]).all()
    # the jitter factorizes it in float64
    np.testing.assert_allclose(tm._chol_corr(_t(corr)).numpy(),
                               np.asarray(jm._chol_corr(jnp.asarray(corr))), rtol=0.0,
                               atol=1e-10)
    # and the terminal sample inherits the NaN, no error
    s, _ = tm.sample_terminal_gbm(JaxKey(KEY), _t([100.0, 96.0, 90.0]), _t([0.2, 0.3, 0.25]),
                                  _t(corr), 0.9, n_paths=64, device=CPU)
    want_s, _ = jm.sample_terminal_gbm(KEY, jnp.asarray([100.0, 96.0, 90.0]),
                                       jnp.asarray([0.2, 0.3, 0.25]), jnp.asarray(corr), 0.9,
                                       n_paths=64)
    np.testing.assert_array_equal(np.isnan(s.numpy()), np.isnan(np.asarray(want_s)))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_basket_control_variate_consistent_and_tighter():
    """tests/test_multi_asset.py::TestBasketMC on the port's own draws."""
    spots, w = _t([100.0, 95.0, 105.0, 98.0]), _t([0.3, 0.2, 0.25, 0.25])
    vols = _t([0.2, 0.3, 0.25, 0.35])
    corr = _t(0.3 * np.ones((4, 4)) + 0.7 * np.eye(4))
    args = (spots, w, _t([90.0, 100.0, 110.0]), 0.9, vols, corr)
    p_cv, se_cv = tm.price_basket_mc(_gen(3), *args, rate=0.03, n_paths=1 << 16, device=CPU)
    p_raw, se_raw = tm.price_basket_mc(_gen(3), *args, rate=0.03, n_paths=1 << 16,
                                       control_variate=False, device=CPU)
    assert bool(((p_cv - p_raw).abs() < 4.0 * se_raw).all())
    assert bool((se_cv * 3.0 < se_raw).all())


def test_geometric_payoff_spread_and_rainbow_against_closed_forms():
    spots, vols = _t([100.0, 95.0, 105.0]), _t([0.2, 0.3, 0.25])
    corr = _t(0.5 * np.ones((3, 3)) + 0.5 * np.eye(3))
    w = _t([0.4, 0.3, 0.3])
    s_t, _ = tm.sample_terminal_gbm(_gen(7), spots, vols, corr, 0.9, 0.03, 0.015,
                                    n_paths=1 << 16, device=CPU)
    df = float(np.exp(-0.03 * 0.9))
    pay = df * torch.clamp_min(torch.exp(torch.log(s_t.double()) @ w) - 100.0, 0.0)
    half = pay.shape[0] // 2
    paired = 0.5 * (pay[:half] + pay[half:])
    want = float(tm.geometric_basket_price(spots, w, 100.0, 0.9, vols, corr, rate=0.03,
                                           dividends=0.015))
    assert abs(float(paired.mean()) - want) < 4.0 * float(paired.std() / np.sqrt(half))
    pair = dict(vol1=_t(0.25), vol2=_t(0.35), rho=_t(0.55), **PAIR)
    p, se = tm.price_spread_mc(_gen(11), _t(100.0), _t(96.0), 5.0, n_paths=1 << 16,
                               device=CPU, **pair)
    want = float(tm.spread_price_quad(_t(100.0), _t(96.0), 5.0, **pair))
    assert abs(float(p) - want) < 4.0 * float(se) and float(se) < 0.05
    for kind in ("call_on_max", "put_on_min"):
        p, se = tm.price_rainbow_mc(_gen(17), _t(100.0), _t(96.0), 100.0, kind=kind,
                                    n_paths=1 << 16, device=CPU, **pair)
        want = float(tm.rainbow_two_asset_price(_t(100.0), _t(96.0), 100.0, kind=kind, **pair))
        assert abs(float(p) - want) < 4.0 * float(se), kind
