"""``pde_tpu_torch.models.varswap`` held against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU:
the CIR Laplace transform with the Bates and SVCJ hooks, the variance and
volatility strikes, the convexity rule (nested ``torch.func.grad`` against
nested ``jax.grad``), the strip and its jump bias, at 1e-12 relative (the
quadratures at 1e-10).  The JAX suite's oracle is kept: the strip of a
converged-CF Heston chain is the fair variance strike.
"""

import numpy as np
import pytest
import torch

from pde_tpu.models import bates as jb
from pde_tpu.models import heston as jh
from pde_tpu.models import svcj as js
from pde_tpu.models import varswap as jv
from pde_tpu_torch import interop
from pde_tpu_torch.models import heston as th
from pde_tpu_torch.models import varswap as tv

HP = jh.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
BP = jb.BatesParams(2.0, 0.04, 0.3, -0.7, 0.04, 0.6, -0.08, 0.18)
SP = js.SVCJParams(2.0, 0.04, 0.3, -0.7, 0.04, 0.5, -0.1, 0.15, 0.05, -0.5)
MODELS = {"heston": (HP, interop.heston_params(HP)), "bates": (BP, interop.bates_params(BP)),
          "svcj": (SP, interop.svcj_params(SP))}


def _t(x):
    return interop.tensor(x)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_laplace_transforms_match_reference(model):
    jp, tp = MODELS[model]
    s = np.linspace(0.0, 40.0, 21)
    for T in (0.1, 1.0, 5.0):
        np.testing.assert_allclose(
            tv.integrated_variance_log_laplace(tp, _t(s), _t(T)).numpy(),
            np.asarray(jv.integrated_variance_log_laplace(jp, s, T)), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(
            tv.integrated_variance_laplace(tp, _t(s), _t(T)).numpy(),
            np.asarray(jv.integrated_variance_laplace(jp, s, T)), rtol=1e-12)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_strikes_match_reference(model):
    jp, tp = MODELS[model]
    for T in (0.05, 0.5, 2.0):
        np.testing.assert_allclose(float(tv.fair_variance_strike(tp, _t(T))),
                                   float(jv.fair_variance_strike(jp, T)), rtol=1e-13)
        np.testing.assert_allclose(float(tv.fair_volatility_strike(tp, _t(T))),
                                   float(jv.fair_volatility_strike(jp, T)), rtol=1e-10)
    np.testing.assert_allclose(float(tv.forward_variance(tp, _t(0.25), _t(1.5))),
                               float(jv.forward_variance(jp, 0.25, 1.5)), rtol=1e-12)
    np.testing.assert_allclose(
        float(tv.fair_volatility_strike(tp, _t(0.5), n_nodes=64)),
        float(jv.fair_volatility_strike(jp, 0.5, n_nodes=64)), rtol=1e-10)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_convexity_approx_matches_nested_jax_grad(model):
    jp, tp = MODELS[model]
    for T in (0.25, 1.0):
        np.testing.assert_allclose(float(tv.volatility_convexity_approx(tp, _t(T))),
                                   float(jv.volatility_convexity_approx(jp, T)), rtol=1e-12)


def _otm_chain(tp, T, S0=100.0, r=0.03, q=0.01, n=1200):
    """A dense OTM chain priced by the port's converged CF pricer."""
    F = S0 * np.exp((r - q) * T)
    K = np.linspace(0.25 * F, 4.0 * F, n)
    prices = th.price_accurate(tp, _t(K), _t(T), S0, r, q,
                               is_call=torch.as_tensor(K > F)).numpy()
    return K, prices, F


def test_strip_matches_reference(rng):
    K = np.sort(rng.uniform(40.0, 250.0, 64))
    otm = rng.uniform(0.01, 5.0, 64)
    for F in (30.0, 101.0, 300.0):  # below, inside and above the strikes
        np.testing.assert_allclose(float(tv.strip_variance(_t(K), _t(otm), F, 0.5, 0.03)),
                                   float(jv.strip_variance(K, otm, F, 0.5, 0.03)), rtol=1e-13)
        np.testing.assert_allclose(float(tv.vix_index(_t(K), _t(otm), F, 0.5, 0.03)),
                                   float(jv.vix_index(K, otm, F, 0.5, 0.03)), rtol=1e-13)


def test_strip_replicates_heston_fair_variance():
    """Pure diffusion: the log-contract strip is the variance swap
    (tests/test_varswap.py:124-129, the same 2e-3)."""
    tp = MODELS["heston"][1]
    K, prices, F = _otm_chain(tp, 0.5)
    strip = float(tv.strip_variance(_t(K), _t(prices), F, 0.5, 0.03))
    np.testing.assert_allclose(strip, float(tv.fair_variance_strike(tp, _t(0.5))), rtol=2e-3)


def test_strip_jump_bias():
    """Under Bates jumps the strip lands on fair + bias, and the bias is
    the reference's."""
    tp = MODELS["bates"][1]
    bias = float(tv.strip_jump_bias(tp))
    np.testing.assert_allclose(bias, float(jv.strip_jump_bias(BP)), rtol=1e-14)
    assert abs(bias) > 5e-4
    K, prices, F = _otm_chain(tp, 0.5)
    strip = float(tv.strip_variance(_t(K), _t(prices), F, 0.5, 0.03))
    np.testing.assert_allclose(strip, float(tv.fair_variance_strike(tp, _t(0.5))) + bias,
                               rtol=2e-3)
    assert float(tv.strip_jump_bias(MODELS["heston"][1])) == 0.0


def test_gl01_is_the_reference_s():
    for a, b in zip(tv._gl01(32), jv._gl01(32)):
        np.testing.assert_array_equal(a, b)
        assert isinstance(a, np.ndarray)


@pytest.mark.parametrize("model", ["bates", "svcj"])
def test_float32_vol_strike_keeps_its_digits(model):
    """The card runs float32: the port's cancellation-free log-Laplace
    (the CIR log A, and SVCJ's jump correction with its -1 inside the
    quadrature sums) keeps the vol-swap strike within 1e-6 of float64,
    where the reference's forms (O(1) terms cancelling to an O(s) result)
    cost its own float32 run more than 1e-5 (run under
    ``jax.enable_x64(False)``)."""
    import jax

    jp, _ = MODELS[model]
    ref64 = float(jv.fair_volatility_strike(jp, 0.5))
    with jax.enable_x64(False):
        ref32 = float(jv.fair_volatility_strike(type(jp)(*jp), 0.5))
    convert = interop.bates_params if model == "bates" else interop.svcj_params
    port32 = float(tv.fair_volatility_strike(convert(jp, dtype=torch.float32),
                                             torch.tensor(0.5)))
    assert abs(port32 - ref64) / ref64 < 1e-6
    assert abs(ref32 - ref64) / ref64 > 1e-5
