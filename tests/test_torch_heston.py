"""The PyTorch port's pricing slice held against the JAX package.

Same seeded inputs through ``pde_tpu`` (x64, as the whole suite runs it)
and ``pde_tpu_torch`` (float64 on the CPU, and float32/complex64 — the
GPU's working type): grids, Black-Scholes price and implied vol, and the
Heston Carr-Madan pricers on a 12 x 9 surface.  Gates: 1e-8 absolute on
price and 1e-6 on implied vol in float64 (the repo's parity gates);
1e-5 relative on quotes >= 0.01 in float32.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.core import grids as jgrids
from pde_tpu.models import black_scholes as jbs
from pde_tpu.models import heston as jh
from pde_tpu_torch import interop
from pde_tpu_torch.core import grids as tgrids
from pde_tpu_torch.core import precision as tprec
from pde_tpu_torch.models import black_scholes as tbs
from pde_tpu_torch.models import heston as th

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S0, R, Q = 100.0, 0.05, 0.02
PARAMS = jh.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
F64, F32 = torch.float64, torch.float32


@pytest.fixture(scope="module")
def surface():
    """12 strikes x 9 maturities (bench.py's surface), calls above the
    money and puts below, flattened."""
    K, T = np.meshgrid(np.linspace(85.0, 115.0, 12), np.linspace(0.25, 1.5, 9))
    K, T = K.ravel(), T.ravel()
    return K, T, K >= S0


def _grouped(T, dtype):
    unique_T, t_idx = jh.group_maturities(T)
    return (unique_T, t_idx), interop.grouping(t_idx, unique_T, dtype=dtype)


class TestPrecision:
    def test_result_dtype_follows_tensors(self):
        assert tprec.result_dtype(1.0, 2) == torch.get_default_dtype()
        assert tprec.result_dtype(torch.ones(2, dtype=F64), 1.0) == F64
        assert tprec.result_dtype(torch.ones(2, dtype=torch.int32)) == tprec.default_float()
        assert tprec.complex_dtype_for(F64) == torch.complex128
        assert tprec.complex_dtype_for(F32) == torch.complex64
        assert tprec.EPS(F32) == float(np.finfo(np.float32).eps)


class TestGrids:
    @pytest.mark.parametrize("x", [0.3, 1.0, 2.49, -1.0, 7.0])
    def test_find_index_and_interp_linear(self, x):
        g = np.linspace(0.0, 5.0, 11) ** 1.2
        vals = np.sin(g)
        tg = interop.tensor(g)
        assert int(tgrids.find_index(tg, x)) == int(jgrids.find_index(jnp.asarray(g), x))
        np.testing.assert_allclose(
            float(tgrids.interp_linear(tg, interop.tensor(vals), x)),
            float(jgrids.interp_linear(jnp.asarray(g), jnp.asarray(vals), x)),
            rtol=0, atol=1e-12)

    def test_interp_bilinear_batched_matches_per_grid(self, rng):
        xg = np.sort(rng.uniform(50, 200, (3, 9)), axis=1)
        yg = np.linspace(0.0, 1.0, 7)
        vals = rng.normal(size=(3, 9, 7))
        x = rng.uniform(60, 190, 3)
        y = rng.uniform(0.05, 0.95, 3)
        got = tgrids.interp_bilinear(interop.tensor(xg), interop.tensor(yg),
                                     interop.tensor(vals), interop.tensor(x),
                                     interop.tensor(y)).numpy()
        want = [float(jgrids.interp_bilinear(xg[b], yg, vals[b], x[b], y[b]))
                for b in range(3)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert tgrids.uniform_grid(0.0, 1.0, 5, dtype=F64, device="cpu").dtype == F64


class TestBlackScholes:
    def test_price_and_implied_vol_f64(self, surface):
        K, T, calls = surface
        vol = 0.15 + 0.1 * (K / 100.0 - 1.0) ** 2 + 0.02 * T
        want = np.asarray(jbs.price(S0, K, R, Q, T, vol, calls))
        got = tbs.price(S0, interop.tensor(K), R, Q, interop.tensor(T),
                        interop.tensor(vol), torch.as_tensor(calls)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
        iv_j = np.asarray(jbs.implied_vol(want, S0, K, R, Q, T, calls))
        iv_t = tbs.implied_vol(interop.tensor(want), S0, interop.tensor(K), R, Q,
                               interop.tensor(T), torch.as_tensor(calls)).numpy()
        np.testing.assert_allclose(iv_t, iv_j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(iv_t, vol, rtol=0, atol=1e-6)

    def test_vega_and_short_newton(self, surface):
        K, T, calls = surface
        want = np.asarray(jbs.vega(S0, K, R, Q, T, 0.2))
        got = tbs.vega(S0, interop.tensor(K), R, Q, interop.tensor(T), 0.2).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
        price = np.asarray(jbs.price(S0, K, R, Q, T, 0.25, calls))
        iv_j = np.asarray(jbs.implied_vol(price, S0, K, R, Q, T, calls, max_iter=8))
        iv_t = tbs.implied_vol(interop.tensor(price), S0, interop.tensor(K), R, Q,
                               interop.tensor(T), torch.as_tensor(calls), max_iter=8)
        np.testing.assert_allclose(iv_t.numpy(), iv_j, rtol=0, atol=1e-6)


class TestHestonPricing:
    def test_characteristic_function_f64(self):
        u = np.linspace(0.01, 10.0, 50) - 1.75j
        want = np.asarray(jh.characteristic_function(PARAMS, u, 0.7, S0, R, Q))
        got = th.characteristic_function(interop.heston_params(PARAMS),
                                         torch.as_tensor(u), interop.tensor(0.7),
                                         interop.tensor(S0), R, Q).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    @pytest.mark.parametrize("pricer", ["price_carr_madan", "price_accurate"])
    def test_ungrouped_f64(self, surface, pricer):
        K, T, calls = surface
        want = np.asarray(getattr(jh, pricer)(PARAMS, K, T, S0, R, Q, calls))
        got = getattr(th, pricer)(interop.heston_params(PARAMS), interop.tensor(K),
                                  interop.tensor(T), S0, R, Q,
                                  torch.as_tensor(calls)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)

    @pytest.mark.parametrize("pricer", ["price_carr_madan_grouped",
                                        "price_carr_madan_gl_grouped"])
    def test_grouped_f64(self, surface, pricer):
        K, T, calls = surface
        (uT, ti), (tti, tuT) = _grouped(T, F64)
        want = np.asarray(getattr(jh, pricer)(PARAMS, K, ti, uT, S0, R, Q, calls))
        got = getattr(th, pricer)(interop.heston_params(PARAMS), interop.tensor(K),
                                  tti, tuT, S0, R, Q, torch.as_tensor(calls)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)

    @pytest.mark.parametrize("pricer", ["price_carr_madan",
                                        "price_carr_madan_grouped",
                                        "price_carr_madan_gl_grouped"])
    def test_complex64_path(self, surface, pricer):
        """float32/complex64 — the card's working type — against the
        reference's float64 prices on the calibration surface (calls): the
        forward-moneyness form keeps 1e-5 relative."""
        K, T, _ = surface
        (uT, ti), (tti, tuT) = _grouped(T, F32)
        p32 = interop.heston_params(PARAMS, dtype=F32)
        if pricer == "price_carr_madan":
            want = np.asarray(jh.price_carr_madan(PARAMS, K, T, S0, R, Q))
            got = th.price_carr_madan(p32, interop.tensor(K, dtype=F32),
                                      interop.tensor(T, dtype=F32), S0, R, Q)
        else:
            want = np.asarray(getattr(jh, pricer)(PARAMS, K, ti, uT, S0, R, Q))
            got = getattr(th, pricer)(p32, interop.tensor(K, dtype=F32), tti, tuT,
                                      S0, R, Q)
        assert got.dtype == F32
        keep = want >= 0.01
        np.testing.assert_allclose(got.numpy()[keep], want[keep], rtol=1e-5, atol=0)

    def test_population_batch_matches_one_by_one(self, surface):
        """Parameters of shape (P, 1, 1) price a DE population in one call."""
        K, T, calls = surface
        _, (tti, tuT) = _grouped(T, F64)
        pop = np.array([[2.0, 0.04, 0.3, -0.7, 0.04], [1.2, 0.09, 0.6, -0.3, 0.02]])
        batch = th.HestonParams(*(interop.tensor(pop[:, i, None, None]) for i in range(5)))
        got = th.price_carr_madan_gl_grouped(batch, interop.tensor(K), tti, tuT,
                                             S0, R, Q, torch.as_tensor(calls)).numpy()
        for m in range(2):
            one = th.price_carr_madan_gl_grouped(th.HestonParams(*pop[m]),
                                                 interop.tensor(K), tti, tuT, S0,
                                                 R, Q, torch.as_tensor(calls)).numpy()
            np.testing.assert_allclose(got[m], one, rtol=0, atol=1e-12)

    def test_group_maturities_and_moment_explosion(self):
        T = np.array([1.0, 0.5, 1.0, 0.25])
        for a, b in zip(th.group_maturities(T, pad_to=4), jh.group_maturities(T, pad_to=4)):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError):
            th.group_maturities(T, pad_to=2)
        for p in (PARAMS, jh.HestonParams(1.345, 0.192, 1.601, 0.286, 0.724)):
            assert th.moment_explosion_time(p, 1.75) == pytest.approx(
                jh.moment_explosion_time(p, 1.75), rel=1e-12)


def test_port_imports_no_jax():
    """Every module of pde_tpu_torch, and chip_smoke.py, import without
    pulling in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pde_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(pde_tpu_torch.__path__, 'pde_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'pde_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('pde_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
