"""``pde_tpu_torch.models.vix`` held against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU:
the CIR terminal law and density (``torch.special.gammaln`` and
``torch.logsumexp`` for JAX's), the squared-VIX coefficients, futures by
both routes, options and the term structure at 1e-10 relative.  The JAX
suite's cross-checks are kept: the Schuerger and density futures agree,
and options obey put-call parity on the future.
"""

import numpy as np
import pytest
import torch

from pde_tpu.models import bates as jb
from pde_tpu.models import heston as jh
from pde_tpu.models import vix as jx
from pde_tpu_torch import interop
from pde_tpu_torch.models import vix as tx

HP = jh.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
BP = jb.BatesParams(2.0, 0.04, 0.3, -0.7, 0.04, 0.6, -0.08, 0.18)
MODELS = {"heston": (HP, interop.heston_params(HP)), "bates": (BP, interop.bates_params(BP))}


def _t(x):
    return interop.tensor(x)


def test_tenor_is_the_reference_s():
    assert tx.VIX_TENOR == jx.VIX_TENOR


@pytest.mark.parametrize("model", sorted(MODELS))
def test_terminal_law_and_density_match_reference(model):
    jp, tp = MODELS[model]
    for T in (0.05, 0.5, 2.0):
        for a, b in zip(tx.cir_terminal_law(tp, _t(T)), jx.cir_terminal_law(jp, T)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)
        v = np.linspace(1e-4, 0.25, 17)
        np.testing.assert_allclose(tx.cir_terminal_logpdf(tp, _t(T), _t(v)).numpy(),
                                   np.asarray(jx.cir_terminal_logpdf(jp, T, v)), rtol=1e-12,
                                   atol=1e-12)
        s = np.linspace(0.0, 300.0, 9)
        np.testing.assert_allclose(tx._terminal_log_laplace(tp, _t(T), _t(s)).numpy(),
                                   np.asarray(jx._terminal_log_laplace(jp, T, s)),
                                   rtol=1e-13, atol=1e-16)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_coefficients_spot_and_jump_rate_match_reference(model):
    jp, tp = MODELS[model]
    for tenor in (jx.VIX_TENOR, 0.25):
        for a, b in zip(tx.vix_squared_coeffs(tp, tenor), jx.vix_squared_coeffs(jp, tenor)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)
        np.testing.assert_allclose(tx.vix_spot(tp, tenor).numpy(),
                                   np.asarray(jx.vix_spot(jp, tenor)), rtol=1e-14)
    np.testing.assert_allclose(
        tx._jump_strip_rate(tp, torch.float64, torch.device("cpu")).numpy(),
        np.asarray(jx._jump_strip_rate(jp, np.float64)), rtol=1e-14)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_futures_match_reference(model):
    jp, tp = MODELS[model]
    for T in (0.1, 0.5, 1.5):
        np.testing.assert_allclose(float(tx.vix_futures(tp, _t(T))),
                                   float(jx.vix_futures(jp, T)), rtol=1e-12)
        np.testing.assert_allclose(float(tx.vix_futures_density(tp, _t(T))),
                                   float(jx.vix_futures_density(jp, T)), rtol=1e-12)
    mats = [0.05, 0.25, 0.5, 1.0, 2.0]
    np.testing.assert_allclose(tx.vix_futures_term(tp, _t(mats)).numpy(),
                               np.asarray(jx.vix_futures_term(jp, mats)), rtol=1e-12)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("is_call", [True, False])
def test_options_match_reference(model, is_call):
    jp, tp = MODELS[model]
    K = np.linspace(12.0, 35.0, 9)
    want = np.asarray(jx.vix_option(jp, K, 0.5, 0.02, is_call=is_call))
    got = tx.vix_option(tp, _t(K), _t(0.5), 0.02, is_call=is_call)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-12)


def test_implied_vol_matches_reference():
    tp = MODELS["heston"][1]
    K = np.linspace(14.0, 30.0, 7)
    fut = float(jx.vix_futures_density(HP, 0.5))
    prices = np.asarray(jx.vix_option(HP, K, 0.5, 0.02))
    want = np.asarray(jx.vix_implied_vol(prices, fut, K, 0.5, 0.02))
    got = tx.vix_implied_vol(_t(prices), _t(fut), _t(K), _t(0.5), 0.02)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(float(tx.vix_futures_density(tp, _t(0.5))), fut, rtol=1e-12)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_routes_agree_and_parity_holds(model):
    """The two futures routes and put-call parity on the future
    (tests/test_vix.py's cross-checks)."""
    _, tp = MODELS[model]
    T, r = 0.5, 0.02
    fut = float(tx.vix_futures(tp, _t(T)))
    np.testing.assert_allclose(float(tx.vix_futures_density(tp, _t(T))), fut, rtol=1e-5)
    K = np.linspace(14.0, 30.0, 7)
    call = tx.vix_option(tp, _t(K), _t(T), r)
    put = tx.vix_option(tp, _t(K), _t(T), r, is_call=False)
    np.testing.assert_allclose((call - put).numpy(), np.exp(-r * T) * (fut - K), atol=1e-3)


def test_gl01_is_the_reference_s():
    for a, b in zip(tx._gl01(64), jx._gl01(64)):
        np.testing.assert_array_equal(a, b)
