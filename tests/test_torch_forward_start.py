"""``pde_tpu_torch.models.forward_start`` held against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU:
the chi-square-mixed CF factor and the forward-start and cliquet prices at
1e-8.  The JAX suite's oracles are kept: t0 -> 0 is the vanilla, and a
point-mass variance (sigma -> 0) is the deferred vanilla to round-off,
which the complex ``log1p`` of the hook makes possible.
"""

import numpy as np
import pytest
import torch

from pde_tpu.models import forward_start as jf
from pde_tpu.models import heston as jh
from pde_tpu_torch import interop
from pde_tpu_torch.models import forward_start as tf
from pde_tpu_torch.models import heston as th

F64, C128 = torch.float64, torch.complex128
P = jh.HestonParams(2.0, 0.04, 0.5, -0.7, 0.04)
DET = jh.HestonParams(2.0, 0.04, 1e-7, 0.0, 0.04)
KS = np.linspace(0.7, 1.3, 13)


def _tp(p=P):
    return interop.heston_params(p)


@pytest.mark.parametrize("t0", [0.0, 0.25, 1.0])
def test_cf_reduced_extra_matches_reference(rng, t0):
    u = rng.uniform(0.0, 40.0, 31) - 1j * rng.uniform(0.0, 2.0, 31)
    Tm = np.array([[0.1], [0.5], [1.5]])
    jp = jf.ForwardStartParams(*P, t0)
    want = np.asarray(jp.cf_reduced_extra(u, Tm, np.float64, np.complex128))
    got = interop.forward_start_params(jp).cf_reduced_extra(
        torch.as_tensor(u), interop.tensor(Tm), F64, C128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-14)


@pytest.mark.parametrize("fixing,maturity", [(0.0, 1.0), (0.5, 1.0), (0.25, 2.0)])
@pytest.mark.parametrize("is_call", [True, False])
def test_price_forward_start_matches_reference(fixing, maturity, is_call):
    want = np.asarray(jf.price_forward_start(P, KS, fixing, maturity, rate=0.05,
                                             dividend=0.02, is_call=is_call, notional=3.0))
    got = tf.price_forward_start(_tp(), interop.tensor(KS), fixing, maturity, rate=0.05,
                                 dividend=0.02, is_call=is_call, notional=3.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)


@pytest.mark.parametrize("n_periods,cap", [(4, 0.08), (12, 0.05)])
def test_cliquet_strip_matches_reference(n_periods, cap):
    want = float(jf.price_cliquet_strip(P, 1.0, n_periods=n_periods, local_floor=-0.02,
                                        local_cap=cap, notional=2.0, rate=0.03,
                                        dividend=0.01))
    got = tf.price_cliquet_strip(_tp(), interop.tensor(1.0), n_periods=n_periods,
                                 local_floor=-0.02, local_cap=cap, notional=2.0, rate=0.03,
                                 dividend=0.01)
    assert got.dtype == F64
    np.testing.assert_allclose(float(got), want, atol=1e-8, rtol=0)


def test_t0_zero_reduces_to_vanilla():
    p0 = tf.price_forward_start(_tp(), interop.tensor(1.0), 0.0, 1.0, rate=0.05,
                                dividend=0.02)
    van = th.price_accurate(_tp(), interop.tensor(1.0), interop.tensor(1.0), 1.0, 0.05, 0.02)
    np.testing.assert_allclose(float(p0), float(van), rtol=1e-12)


def test_point_mass_variance_reduces_to_deferred_vanilla():
    """sigma -> 0, v0 = theta: the mixing factor is 1 to round-off only if
    delta * log1p(-2cD) keeps its absolute accuracy (tests/
    test_forward_start_analytic.py:30-44, the same 1e-10)."""
    r, q, t0, T = 0.05, 0.02, 0.5, 1.0
    k = interop.tensor([0.9, 1.0, 1.1])
    p = tf.price_forward_start(_tp(DET), k, t0, T, rate=r, dividend=q)
    van = np.exp(-r * t0) * th.price_accurate(_tp(DET), k, interop.tensor(T - t0), 1.0, r,
                                              q, True).numpy()
    np.testing.assert_allclose(p.numpy(), van, atol=1e-10)


def test_put_call_parity_on_forward_return():
    r, q, t0, T = 0.05, 0.02, 0.4, 1.3
    c = tf.price_forward_start(_tp(), interop.tensor(KS), t0, T, rate=r, dividend=q)
    p = tf.price_forward_start(_tp(), interop.tensor(KS), t0, T, rate=r, dividend=q,
                               is_call=False)
    parity = np.exp(-r * t0) * (np.exp(-q * (T - t0)) - KS * np.exp(-r * (T - t0)))
    np.testing.assert_allclose((c - p).numpy(), parity, atol=1e-8)


def test_heston_of_forward_start_params():
    fsp = tf.ForwardStartParams(*(interop.tensor(v) for v in (*P, 0.5)))
    assert tuple(float(x) for x in fsp.heston()) == tuple(P)
