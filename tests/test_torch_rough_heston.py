"""``pde_tpu_torch.models.rough_heston`` and ``calibrate.rough`` held
against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU,
at ``n_steps`` of 8-16: the fractional-Riccati CF, the smile prices (1e-8)
and vols (1e-6), and ``torch.func.jacfwd`` through the march against
``jax.jacfwd`` through the scan.  The JAX suite's oracles are kept: H = 1/2
is classic Heston, and phi(0) = phi(-i) = 1.  The LM fits are
deterministic (no random draws), so the converged parameters of both
packages agree closely; each fit also recovers its synthetic surface.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.calibrate import rough as jcal
from pde_tpu.models import heston as jh
from pde_tpu.models import rough_heston as jr
from pde_tpu_torch import interop
from pde_tpu_torch.calibrate import rough as tcal
from pde_tpu_torch.models import heston as th
from pde_tpu_torch.models import rough_heston as tr

F64, C128 = torch.float64, torch.complex128
ROUGH = jr.RoughHestonParams(0.1, 2.0, 0.04, 0.3, -0.7, 0.04)
ROUGH_H12 = jr.RoughHestonParams(0.5, 2.0, 0.04, 0.3, -0.7, 0.04)
KS = np.linspace(80.0, 120.0, 9)


def _t(x):
    return interop.tensor(x)


def _tp(p=ROUGH):
    return interop.rough_heston_params(p)


@pytest.mark.parametrize("n_steps", [8, 16])
@pytest.mark.parametrize("maturity", [0.05, 0.5])
def test_cf_matches_reference(n_steps, maturity):
    u = np.linspace(0.1, 60.0, 17) - 1.75j
    want = np.asarray(jr.cf_reduced_rough(ROUGH, u, maturity, n_steps=n_steps))
    got = tr.cf_reduced_rough(_tp(), torch.as_tensor(u), _t(maturity), n_steps=n_steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("n_steps", [8, 16])
@pytest.mark.parametrize("is_call", [True, False])
def test_price_and_vols_match_reference(n_steps, is_call):
    want = np.asarray(jr.price_rough(ROUGH, KS, 0.25, 100.0, 0.05, 0.02, is_call,
                                     n_steps=n_steps))
    got = tr.price_rough(_tp(), _t(KS), _t(0.25), 100.0, 0.05, 0.02, is_call,
                         n_steps=n_steps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)
    want = np.asarray(jr.implied_vol_rough(ROUGH, KS, 0.25, 100.0, 0.05, 0.02, is_call,
                                           n_steps=n_steps))
    got = tr.implied_vol_rough(_tp(), _t(KS), _t(0.25), 100.0, 0.05, 0.02, is_call,
                               n_steps=n_steps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_surface_in_one_march_is_the_smiles():
    """price_rough on (M,) maturities and (M, K) strikes is M smiles."""
    mats = np.array([0.05, 0.25, 1.0])
    grid = tr.price_rough(_tp(), _t(np.tile(KS, (3, 1))), _t(mats), 100.0, 0.02, 0.0,
                          n_steps=12)
    for i, T in enumerate(mats):
        want = np.asarray(jr.price_rough(ROUGH, KS, T, 100.0, 0.02, 0.0, n_steps=12))
        np.testing.assert_allclose(grid[i].numpy(), want, atol=1e-8, rtol=0)


def test_jacfwd_through_the_march_matches_jax():
    """The calibrator's Jacobian: d prices / d (H, lam, theta, nu, rho, v0)
    through the fractional-Riccati loop."""
    x = np.array([0.12, 1.8, 0.05, 0.35, -0.6, 0.045])

    def jprices(x):
        return jr.price_rough(jr.RoughHestonParams(*x), jnp.asarray(KS), 0.3, 100.0, 0.02,
                              0.0, n_steps=8)

    def tprices(x):
        return tr.price_rough(tr.RoughHestonParams(*x), _t(KS), _t(0.3), 100.0, 0.02, 0.0,
                              n_steps=8)

    want = np.asarray(jax.jacfwd(jprices)(jnp.asarray(x)))
    got = torch.func.jacfwd(tprices)(_t(x))
    assert tuple(got.shape) == want.shape == (9, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-9)
    # and batched over starts, as the LM runs it
    batch = torch.func.vmap(torch.func.jacfwd(tprices))(_t(np.stack([x, x * 1.01])))
    np.testing.assert_allclose(batch[0].numpy(), want, rtol=1e-8, atol=1e-9)


def test_classic_limit_at_h_half():
    """alpha = 1: the Adams solution reproduces the closed-form Heston CF
    (tests/test_rough_heston.py:31-43, the same 5e-4)."""
    u = np.linspace(0.1, 60.0, 13) - 1.75j
    cf_r = tr.cf_reduced_rough(_tp(ROUGH_H12), torch.as_tensor(u), _t(1.0),
                               n_steps=512).numpy()
    heston = th.HestonParams(*(_t(v) for v in (2.0, 0.04, 0.3, -0.7, 0.04)))
    cf_h = th._cf_reduced(heston, torch.as_tensor(u), _t(1.0), F64, C128).numpy()
    assert np.max(np.abs(cf_r - cf_h) / np.abs(cf_h)) < 5e-4


def test_cf_identities():
    one = tr.cf_reduced_rough(_tp(), torch.tensor([0.0 + 0.0j, -1j], dtype=C128), _t(1.0))
    np.testing.assert_allclose(one.numpy(), [1.0, 1.0], atol=1e-12)
    cf = tr.cf_reduced_rough(_tp(), torch.linspace(0.1, 80.0, 40, dtype=F64).to(C128),
                             _t(0.5), n_steps=64)
    assert float(cf.abs().max()) <= 1.0 + 1e-10
    assert complex(tr.cf_reduced_rough(_tp(), torch.tensor([3.0 + 0j], dtype=C128),
                                       _t(0.0))[0]) == 1.0


@pytest.mark.parametrize("bad,match", [
    (dict(hurst=0.0), "hurst"), (dict(hurst=0.6), "hurst"), (dict(nu=0.0), "nu"),
    (dict(rho=-1.0), "rho"),
])
def test_validate_raises_as_reference(bad, match):
    jp = ROUGH._replace(**bad)
    with pytest.raises(ValueError, match=match):
        jp.validate()
    with pytest.raises(ValueError, match=match):
        _tp(jp).validate()
    _tp().validate()


def test_helpers_match_reference():
    x = np.array([0.6, 1.5, 2.5, 3.7])
    np.testing.assert_allclose(tr._gamma(_t(x)).numpy(), np.asarray(jr._gamma(x)),
                               rtol=1e-14)
    u = np.linspace(0.1, 20.0, 7) - 1.75j
    h = np.linspace(-1.0, 1.0, 7) + 0.3j
    want = np.asarray(jr._riccati_F(jnp.asarray(u), h, 2.0, -0.7, 0.3, jnp.complex128))
    got = tr._riccati_F(torch.as_tensor(u), torch.as_tensor(h), 2.0, -0.7, 0.3, C128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)


# --------------------------------------------------------------- calibrator

MATS = (0.1, 0.5)


@pytest.fixture(scope="module")
def surface():
    return jcal.RoughHestonCalibrator.generate_synthetic_surface(maturities=MATS, n_steps=12)


def test_synthetic_surface_matches_reference(surface):
    got = tcal.RoughHestonCalibrator.generate_synthetic_surface(maturities=MATS, n_steps=12,
                                                                device="cpu", dtype=F64)
    np.testing.assert_array_equal(got["strikes"], surface["strikes"])
    np.testing.assert_array_equal(got["maturities"], surface["maturities"])
    np.testing.assert_allclose(got["mid_prices"], surface["mid_prices"], atol=1e-8, rtol=0)
    assert tuple(got["true_params"]) == tuple(surface["true_params"])
    assert got["mid_prices"].shape == (2, 9) and np.all(got["mid_prices"] > 0)


def test_calibrate_converges_where_the_reference_does(surface):
    args = (surface["strikes"], surface["maturities"], surface["mid_prices"],
            surface["S0"], surface["r"], surface["q"])
    ref = jcal.RoughHestonCalibrator(n_steps=12, max_iter=12).calibrate(*args)
    res = tcal.RoughHestonCalibrator(n_steps=12, max_iter=12, device="cpu",
                                     dtype=F64).calibrate(*args)
    np.testing.assert_allclose(list(res.params), list(ref.params), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(res.rmse, ref.rmse, rtol=1e-3, atol=1e-12)
    assert res.n_iter == ref.n_iter and res.converged == ref.converged
    # and the fit recovers the generator
    assert res.rmse < 1e-4
    for name, v in zip(tr.RoughHestonParams._fields, surface["true_params"]):
        assert getattr(res.params, name) == pytest.approx(v, abs=2e-2), name


def test_calibrate_quotes_matches_reference(surface):
    flat = {"strike": surface["strikes"].ravel(),
            "maturity": np.repeat(surface["maturities"], surface["strikes"].shape[1]),
            "mid_price": surface["mid_prices"].ravel()}
    classic = jh.HestonParams(2.0, 0.04, 0.3, -0.65, 0.04)
    ref = jcal.RoughHestonCalibrator(n_steps=12, max_iter=6).calibrate_quotes(
        flat, 100.0, 0.02, 0.0, classic_params=classic)
    res = tcal.RoughHestonCalibrator(n_steps=12, max_iter=6, device="cpu",
                                     dtype=F64).calibrate_quotes(
        flat, 100.0, 0.02, 0.0, classic_params=classic)
    np.testing.assert_allclose(list(res.params), list(ref.params), rtol=1e-6, atol=1e-9)
    assert res.fit_quality == pytest.approx(ref.fit_quality, rel=1e-3)


def test_start_bank_matches_reference():
    x0 = jr.RoughHestonParams(0.3, 1.0, 0.05, 0.5, -0.4, 0.03)
    cal = tcal.RoughHestonCalibrator(device="cpu", dtype=F64)
    for args in ((None, None), (x0, None), (None, jh.HestonParams(2.0, 0.04, 0.3, -0.7,
                                                                   0.04))):
        np.testing.assert_allclose(cal._start(*args).numpy(),
                                   np.asarray(jcal.RoughHestonCalibrator._start(*args)))


def test_best_of_starts_keeps_the_cheapest_run():
    """Two starts of a 1-D least squares: the kept run is the lower cost."""
    def residuals(x):
        return torch.stack([x[0] - 1.0, (x[0] - 1.0) * x[0], 0.0 * x[1]])

    lo, hi = _t([-5.0, 0.0]), _t([5.0, 1.0])
    res = tcal._best_of_starts(residuals, _t([[-4.0, 0.5], [0.8, 0.5]]), lo, hi, 30)
    assert tuple(res.x.shape) == (2,) and float(res.cost) < 1e-12
    assert abs(float(res.x[0]) - 1.0) < 1e-6


def test_input_validation():
    cal = tcal.RoughHestonCalibrator(device="cpu")
    with pytest.raises(ValueError, match="n_mat"):
        cal.calibrate(np.ones(5), np.array([0.5]), np.ones(5), 100.0)
    with pytest.raises(ValueError, match="maturities"):
        cal.calibrate(np.ones((2, 5)), np.array([0.5]), np.ones((2, 5)), 100.0)
    with pytest.raises(ValueError, match="flat shape"):
        cal.calibrate_quotes({"strike": np.ones(3), "maturity": np.ones(2),
                              "mid_price": np.ones(3)}, 100.0)
