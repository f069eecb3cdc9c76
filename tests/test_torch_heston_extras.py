"""The Heston names the port's first slices left out, held against the JAX
package: ``HestonParams.validate/to_array/from_array``, the affine-extension
hook ``cf_reduced_extra`` (Bates' jump factor), the plain Gauss-Legendre
pricers, ``price_carr_madan_gl``, ``price_accurate_grouped``, the implied-vol
trio, ``price_with_greeks``, ``greeks_ad`` and ``price_fft``.

Same seeded inputs through ``pde_tpu`` (x64, as the suite runs it) and
``pde_tpu_torch`` (float64 on the CPU).  Gates: 1e-8 absolute on price,
1e-6 on implied vol, 1e-8 relative or 1e-10 absolute on AD Greeks; the
card's float32/complex64 path is held against the port's own float64.
"""

import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.models import bates as jbates
from pde_tpu.models import heston as jh
from pde_tpu_torch import interop
from pde_tpu_torch.models import heston as th

S0, R, Q = 100.0, 0.05, 0.02
PARAMS = jh.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
F64, F32 = torch.float64, torch.float32
PRICE_ATOL = 1e-8


@pytest.fixture(scope="module")
def surface():
    """12 strikes x 9 maturities (bench.py's surface), calls above the
    money and puts below, flattened."""
    K, T = np.meshgrid(np.linspace(85.0, 115.0, 12), np.linspace(0.25, 1.5, 9))
    K, T = K.ravel(), T.ravel()
    return K, T, K >= S0


def _tp(p=PARAMS, dtype=F64):
    return interop.heston_params(p, dtype=dtype)


def _grouping(T, dtype=F64):
    unique_T, t_idx = jh.group_maturities(T)
    return (unique_T, t_idx), interop.grouping(t_idx, unique_T, dtype=dtype)


# --------------------------------------------------------------- HestonParams

class TestParams:
    @pytest.mark.parametrize("bad,match", [
        (dict(kappa=0.0), "kappa"), (dict(theta=-0.1), "theta"),
        (dict(sigma=0.0), "sigma"), (dict(v0=-1e-3), "v0"),
        (dict(rho=1.0), "rho"), (dict(rho=-1.2), "rho"),
    ])
    def test_validate_raises_as_reference(self, bad, match):
        good = PARAMS._asdict()
        jp = jh.HestonParams(**{**good, **bad})
        with pytest.raises(ValueError, match=match):
            jp.validate()
        with pytest.raises(ValueError, match=match):
            _tp(jp).validate()
        with pytest.raises(ValueError, match=match):
            th.HestonParams(**{**good, **bad}).validate()

    def test_validate_accepts_batched_good_params(self, rng):
        kappa = rng.uniform(0.5, 5.0, 7)
        th.HestonParams(interop.tensor(kappa), 0.04, 0.3, -0.7, 0.04).validate()
        jh.HestonParams(jnp.asarray(kappa), 0.04, 0.3, -0.7, 0.04).validate()

    def test_to_array_and_from_array_match_reference(self, rng):
        kappa = rng.uniform(0.5, 5.0, (3, 1))
        sigma = rng.uniform(0.1, 0.9, (1, 4))
        jp = jh.HestonParams(jnp.asarray(kappa), 0.04, jnp.asarray(sigma), -0.7, 0.04)
        want = np.asarray(jp.to_array())
        got = _tp(jp).to_array()
        assert tuple(got.shape) == want.shape == (3, 4, 5)
        np.testing.assert_array_equal(got.numpy(), want)
        back = th.HestonParams.from_array(got)
        for k in th.HestonParams._fields:
            np.testing.assert_array_equal(getattr(back, k).numpy(),
                                          np.asarray(getattr(jh.HestonParams.from_array(
                                              jnp.asarray(want)), k)))


# ------------------------------------------------------------ the affine hook

class TorchBates(NamedTuple):
    """Bates' eight fields and compensated jump factor (the JAX package's
    ``BatesParams``, pde_tpu/models/bates.py:75-90), on the port's tensors."""

    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    rho: torch.Tensor
    v0: torch.Tensor
    lam: torch.Tensor
    mu_j: torch.Tensor
    sigma_j: torch.Tensor

    def cf_reduced_extra(self, u, T, rdt, cdt):
        lam, mu_j, sj = (torch.as_tensor(x, dtype=rdt, device=u.device)
                         for x in (self.lam, self.mu_j, self.sigma_j))
        kbar = torch.exp(mu_j + 0.5 * sj * sj) - 1.0
        phi_j = torch.exp(1j * u * mu_j - 0.5 * (u * u) * (sj * sj))
        return torch.exp(lam * T * (phi_j - 1.0) - 1j * u * (lam * kbar) * T)


BATES = (2.0, 0.04, 0.3, -0.7, 0.04, 0.5, -0.1, 0.15)


class TestAffineHook:
    def test_characteristic_function_matches_bates(self):
        u = np.linspace(0.01, 12.0, 61) - 1.75j
        jp = jbates.BatesParams(*BATES)
        want = np.asarray(jh.characteristic_function(jp, u, 0.7, S0, R, Q))
        got = th.characteristic_function(TorchBates(*BATES), torch.as_tensor(u),
                                         interop.tensor(0.7), interop.tensor(S0), R, Q)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-10)
        # the jumps do move the CF
        heston = th.characteristic_function(_tp(), torch.as_tensor(u), interop.tensor(0.7),
                                            interop.tensor(S0), R, Q)
        assert float((got - heston).abs().max()) > 1e-3

    def test_gl_grouped_price_matches_bates(self, surface):
        K, T, calls = surface
        (uT, ti), (tti, tuT) = _grouping(T)
        want = np.asarray(jh.price_carr_madan_gl_grouped(
            jbates.BatesParams(*BATES), K, ti, uT, S0, R, Q, calls))
        got = th.price_carr_madan_gl_grouped(TorchBates(*BATES), interop.tensor(K), tti,
                                             tuT, S0, R, Q, torch.as_tensor(calls))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PRICE_ATOL)

    def test_factor_is_one_at_minus_i(self):
        """The hook's contract: the forward is preserved."""
        bates = TorchBates(*(torch.tensor(x, dtype=F64) for x in BATES))
        for T in (0.1, 1.0, 3.0):
            f = bates.cf_reduced_extra(torch.tensor(-1j, dtype=torch.complex128),
                                       torch.tensor(T, dtype=F64), F64, torch.complex128)
            assert abs(complex(f) - 1.0) < 1e-14
            phi = th.characteristic_function(bates, torch.tensor(-1j), interop.tensor(T),
                                             interop.tensor(S0), R, Q)
            forward = S0 * math.exp((R - Q) * T)
            assert abs(complex(phi) - forward) < 1e-10 * forward

    def test_zero_intensity_is_heston_exactly(self, surface):
        K, T, calls = surface
        _, (tti, tuT) = _grouping(T)
        no_jumps = TorchBates(*BATES[:5], 0.0, -0.1, 0.15)
        a = th.price_carr_madan_gl_grouped(no_jumps, interop.tensor(K), tti, tuT, S0, R, Q,
                                           torch.as_tensor(calls))
        b = th.price_carr_madan_gl_grouped(_tp(), interop.tensor(K), tti, tuT, S0, R, Q,
                                           torch.as_tensor(calls))
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------- pricers

class TestPricers:
    @pytest.mark.parametrize("pricer", ["price_gauss_legendre", "price_carr_madan_gl"])
    def test_ungrouped_f64(self, surface, pricer):
        K, T, calls = surface
        want = np.asarray(getattr(jh, pricer)(PARAMS, K, T, S0, R, Q, calls))
        got = getattr(th, pricer)(_tp(), interop.tensor(K), interop.tensor(T), S0, R, Q,
                                  torch.as_tensor(calls))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PRICE_ATOL)

    @pytest.mark.parametrize("pricer", ["price_gauss_legendre_grouped",
                                        "price_accurate_grouped"])
    def test_grouped_f64(self, surface, pricer):
        K, T, calls = surface
        (uT, ti), (tti, tuT) = _grouping(T)
        want = np.asarray(getattr(jh, pricer)(PARAMS, K, ti, uT, S0, R, Q, calls))
        got = getattr(th, pricer)(_tp(), interop.tensor(K), tti, tuT, S0, R, Q,
                                  torch.as_tensor(calls))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PRICE_ATOL)

    def test_grouped_equals_ungrouped(self, surface):
        K, T, calls = surface
        _, (tti, tuT) = _grouping(T)
        grouped = th.price_accurate_grouped(_tp(), interop.tensor(K), tti, tuT, S0, R, Q,
                                            torch.as_tensor(calls))
        flat = th.price_accurate(_tp(), interop.tensor(K), interop.tensor(T), S0, R, Q,
                                 torch.as_tensor(calls))
        np.testing.assert_allclose(grouped.numpy(), flat.numpy(), rtol=0, atol=1e-11)

    @pytest.mark.parametrize("n_points,u_max", [(32, 10.24), (96, 40.0)])
    def test_gauss_legendre_options(self, surface, n_points, u_max):
        K, T, calls = surface
        want = np.asarray(jh.price_gauss_legendre(PARAMS, K, T, S0, R, Q, calls,
                                                  n_points=n_points, u_max=u_max))
        got = th.price_gauss_legendre(_tp(), interop.tensor(K), interop.tensor(T), S0, R,
                                      Q, torch.as_tensor(calls), n_points=n_points,
                                      u_max=u_max)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PRICE_ATOL)

    @pytest.mark.parametrize("pricer", ["price_gauss_legendre", "price_carr_madan_gl"])
    def test_float32_against_float64(self, surface, pricer):
        K, T, _ = surface
        want = getattr(th, pricer)(_tp(), interop.tensor(K), interop.tensor(T), S0, R, Q)
        got = getattr(th, pricer)(_tp(dtype=F32), interop.tensor(K, dtype=F32),
                                  interop.tensor(T, dtype=F32), S0, R, Q)
        assert got.dtype == F32
        keep = want >= 0.01
        np.testing.assert_allclose(got.numpy()[keep.numpy()], want.numpy()[keep.numpy()],
                                   rtol=1e-5, atol=0)


# -------------------------------------------------------------- implied vol

class TestImpliedVol:
    @pytest.mark.parametrize("accurate", [False, True])
    def test_implied_volatility(self, surface, accurate):
        K, T, calls = surface
        want = np.asarray(jh.implied_volatility(PARAMS, K, T, S0, R, Q, calls,
                                                accurate=accurate))
        got = th.implied_volatility(_tp(), interop.tensor(K), interop.tensor(T), S0, R, Q,
                                    torch.as_tensor(calls), accurate=accurate)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("accurate", [False, True])
    def test_implied_volatility_grouped(self, surface, accurate):
        K, T, calls = surface
        (uT, ti), (tti, tuT) = _grouping(T)
        want = np.asarray(jh.implied_volatility_grouped(PARAMS, K, ti, uT, S0, R, Q, calls,
                                                        accurate=accurate))
        got = th.implied_volatility_grouped(_tp(), interop.tensor(K), tti, tuT, S0, R, Q,
                                            torch.as_tensor(calls), accurate=accurate)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("accurate", [False, True])
    def test_implied_volatility_surface(self, accurate):
        Ks, Ts = np.linspace(80.0, 120.0, 9), np.array([0.1, 0.25, 0.5, 1.0, 2.0])
        want = np.asarray(jh.implied_volatility_surface(PARAMS, Ks, Ts, S0, R, Q,
                                                        accurate=accurate))
        got = th.implied_volatility_surface(_tp(), interop.tensor(Ks), interop.tensor(Ts),
                                            S0, R, Q, accurate=accurate)
        assert tuple(got.shape) == want.shape == (5, 9)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    def test_surface_float32_against_float64(self):
        """The card's float32 path: 12 x 9 IVs within 1e-5 of float64
        (9e-7 measured on the CPU)."""
        Ks, Ts = np.linspace(85.0, 115.0, 9), np.linspace(0.25, 1.5, 12)
        want = th.implied_volatility_surface(_tp(), interop.tensor(Ks), interop.tensor(Ts),
                                             S0, R, Q)
        got = th.implied_volatility_surface(_tp(dtype=F32), interop.tensor(Ks, dtype=F32),
                                            interop.tensor(Ts, dtype=F32), S0, R, Q)
        assert got.dtype == F32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


# -------------------------------------------------------------------- Greeks

def _greek_inputs():
    K = np.array([80.0, 95.0, 100.0, 105.0, 125.0])
    T = np.array([0.25, 0.5, 1.0, 1.5, 2.0])
    calls = np.array([True, False, True, False, True])
    return K, T, calls


@pytest.mark.parametrize("scalar_spot", [True, False])
def test_price_with_greeks_matches_reference(scalar_spot):
    K, T, calls = _greek_inputs()
    spot = S0 if scalar_spot else np.full(len(K), S0)
    want = jh.price_with_greeks(PARAMS, K, T, spot if scalar_spot else jnp.asarray(spot),
                                R, Q, calls)
    got = th.price_with_greeks(_tp(), interop.tensor(K), interop.tensor(T),
                               spot if scalar_spot else interop.tensor(spot), R, Q,
                               torch.as_tensor(calls))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=PRICE_ATOL, err_msg=k)


def test_price_with_greeks_zero_theta_inside_a_day():
    got = th.price_with_greeks(_tp(), interop.tensor([100.0, 100.0]),
                               interop.tensor([1.0 / 730.0, 0.5]), S0, R, Q)
    assert float(got["theta"][0]) == 0.0 and float(got["theta"][1]) != 0.0


@pytest.mark.parametrize("strike,maturity,is_call", [
    (100.0, 1.0, True), (90.0, 0.5, False), (115.0, 2.0, True),
])
def test_greeks_ad_matches_reference(strike, maturity, is_call):
    want = jh.greeks_ad(PARAMS, strike, maturity, S0, R, Q, is_call)
    got = th.greeks_ad(_tp(), interop.tensor(strike), interop.tensor(maturity),
                       interop.tensor(S0), R, Q, is_call)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.all(np.abs(g - w) <= np.maximum(1e-10, 1e-8 * np.abs(w))), (k, g, w)
    assert float(got["gamma"]) > 0 and float(got["vega"]) > 0


def test_greeks_ad_book_with_scalar_spot():
    """A strike vector with a scalar spot: the Greeks of the book's sum, as
    ``jax.grad`` of the summed price gives them."""
    K, T, calls = _greek_inputs()
    want = jh.greeks_ad(PARAMS, jnp.asarray(K), jnp.asarray(T), S0, R, Q,
                        jnp.asarray(calls))
    got = th.greeks_ad(_tp(), interop.tensor(K), interop.tensor(T), interop.tensor(S0),
                       R, Q, torch.as_tensor(calls))
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.all(np.abs(g - w) <= np.maximum(1e-10, 1e-8 * np.abs(w))), (k, g, w)


def fd_greeks(params, strike, maturity, spot=S0, is_call=True):
    """``price_with_greeks``' stencils and bumps (heston.cpp:169-218) on
    ``price_accurate``, the pricer ``greeks_ad`` differentiates
    (``price_with_greeks`` itself prices on the reference grid, ~2% off
    at the money, which moves its delta by ~0.02)."""

    def p(s=spot, r=R, t=maturity, v0=params.v0):
        return float(th.price_accurate(params._replace(v0=interop.tensor(v0)),
                                       interop.tensor(strike), interop.tensor(t),
                                       interop.tensor(s), r, Q, is_call))

    es, er, et, ev = spot * 1e-3, 1e-4, 1.0 / 365.0, 1e-3
    v0 = float(params.v0)
    mid, up, dn = p(), p(s=spot + es), p(s=spot - es)
    return {"delta": (up - dn) / (2 * es), "gamma": (up - 2 * mid + dn) / es ** 2,
            "rho": (p(r=R + er) - p(r=R - er)) / (2 * er),
            "theta": (p(t=maturity - et) - mid) / et,
            "vega": (p(v0=v0 + ev) - p(v0=v0 - ev)) / (2 * ev)}


# the stencils' truncation error: O(bump^2) for the central ones, O(1/365)
# for the one-sided theta
FD_RTOL = dict(delta=1e-4, gamma=1e-4, rho=1e-4, vega=1e-4, theta=5e-3)


@pytest.mark.parametrize("strike,maturity,is_call", [
    (100.0, 1.0, True), (90.0, 0.5, False), (115.0, 2.0, True),
])
def test_greeks_ad_under_no_grad_and_near_fd(strike, maturity, is_call):
    """The gradients are taken even when the caller has grad off, and they
    agree with the bump-and-reprice stencils to their truncation error."""
    with torch.no_grad():
        ad = th.greeks_ad(_tp(), interop.tensor(strike), interop.tensor(maturity),
                          interop.tensor(S0), R, Q, is_call)
    fd = fd_greeks(_tp(), strike, maturity, is_call=is_call)
    for k, v in fd.items():
        assert abs(float(ad[k]) - v) <= FD_RTOL[k] * abs(v), (k, float(ad[k]), v)
    assert not ad["gamma"].requires_grad


# ----------------------------------------------------------------------- FFT

@pytest.mark.parametrize("maturity", [0.5, 1.0])
def test_price_fft_matches_reference(maturity):
    k_j, c_j = jh.price_fft(PARAMS, maturity, S0, R, Q)
    k_t, c_t = th.price_fft(_tp(), interop.tensor(maturity), interop.tensor(S0), R, Q)
    assert c_t.dtype == F64 and tuple(c_t.shape) == (4096,)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=0, atol=1e-12)
    # 1e-8 on strikes from 0.01 S0 up; below, e^{-alpha k} >= e^{10} magnifies
    # the two FFT libraries' rounding (MKL or pocketfft against XLA's), so
    # those calls (~S0) agree to 1e-7 relative
    strikes = np.exp(np.asarray(k_j))
    band = strikes >= 0.01 * S0
    np.testing.assert_allclose(c_t.numpy()[band], np.asarray(c_j)[band], rtol=0,
                               atol=PRICE_ATOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-7, atol=PRICE_ATOL)
    assert float(c_t.min()) >= 0.0


def test_price_fft_options_and_accuracy():
    """Other grid sizes match too, and at the money the FFT agrees with the
    converged quadrature to the FFT's own error."""
    k_j, c_j = jh.price_fft(PARAMS, 1.0, S0, R, Q, n_fft=1024, eta=0.5, alpha=1.25)
    k_t, c_t = th.price_fft(_tp(), interop.tensor(1.0), interop.tensor(S0), R, Q,
                            n_fft=1024, eta=0.5, alpha=1.25)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=PRICE_ATOL)
    k_t, c_t = th.price_fft(_tp(), interop.tensor(1.0), interop.tensor(S0), R, Q)
    i = int(torch.argmin((k_t - math.log(S0)).abs()))
    atm = th.price_accurate(_tp(), torch.exp(k_t[i]), interop.tensor(1.0), S0, R, Q)
    assert abs(float(c_t[i]) - float(atm)) < 1e-3


def test_price_fft_complex64_against_complex128():
    """The card's complex64 FFT against the port's complex128 run (not
    against price_accurate: the FFT's own error at eta=0.25 is larger than
    1e-8), on strikes 50-200: within 1e-3 (1e-5 of the spot; 4.8e-5
    measured on the CPU)."""
    k64, c64 = th.price_fft(_tp(), interop.tensor(1.0), interop.tensor(S0), R, Q)
    k32, c32 = th.price_fft(_tp(dtype=F32), interop.tensor(1.0, dtype=F32),
                            interop.tensor(S0, dtype=F32), R, Q)
    assert c32.dtype == F32
    band = (torch.exp(k64) > 50.0) & (torch.exp(k64) < 200.0)
    np.testing.assert_allclose(c32.double()[band].numpy(), c64[band].numpy(), rtol=0,
                               atol=1e-3)
