"""``pde_tpu_torch.models.term_heston`` held against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU:
the Riccati step, the glued CF factor and the prices at 1e-8.  The JAX
suite's oracle is kept: a single interval (or equal intervals) is Heston.
"""

import numpy as np
import pytest
import torch

from pde_tpu.models import heston as jh
from pde_tpu.models import term_heston as jt
from pde_tpu_torch import interop
from pde_tpu_torch.models import heston as th
from pde_tpu_torch.models import term_heston as tt

S0, R, Q = 100.0, 0.05, 0.02
F64, C128 = torch.float64, torch.complex128
EDGES = [0.0, 0.5, 1.0, 3.0]
STEPS = ([2.0, 1.5, 3.0], [0.04, 0.05, 0.03], [0.3, 0.4, 0.2], [-0.7, -0.5, -0.6])
K = np.linspace(75.0, 125.0, 11)


@pytest.fixture(scope="module")
def jp():
    return jt.make_term_params(EDGES, *STEPS, 0.04)


def _tp(p):
    return interop.term_heston_params(p)


def test_riccati_step_matches_reference(rng):
    u = rng.uniform(0.0, 30.0, 17) - 1.75j
    D0 = rng.normal(size=17) * 0.1 + 1j * rng.normal(size=17) * 0.1
    C0 = rng.normal(size=17) * 0.1 + 1j * rng.normal(size=17) * 0.1
    want = jt._riccati_step(u, D0, C0, 2.0, 0.04, 0.3, -0.7, 0.4, 1j)
    got = tt._riccati_step(*(torch.as_tensor(x) for x in (u, D0, C0)), 2.0, 0.04, 0.3, -0.7,
                           interop.tensor(0.4), 1j)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-14)
    # tau = 0 returns the terminal values
    C, D = tt._riccati_step(*(torch.as_tensor(x) for x in (u, D0, C0)), 2.0, 0.04, 0.3, -0.7,
                            interop.tensor(0.0), 1j)
    np.testing.assert_allclose(D.numpy(), D0, atol=1e-14)
    np.testing.assert_allclose(C.numpy(), C0, atol=1e-14)


def test_make_term_params_matches_reference(jp):
    got = tt.make_term_params(EDGES, *STEPS, 0.04, device="cpu", dtype=F64)
    for k in tt.TermHestonParams._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(jp, k)))
    assert tuple(float(x) for x in got.interval_params(1)) == tuple(
        float(x) for x in jp.interval_params(1))


@pytest.mark.parametrize("edges,lists,match", [
    ([0.1, 1.0], ([2.0], [0.04], [0.3], [-0.7]), "edges"),
    ([0.0, 1.0, 0.5], ([2.0] * 2, [0.04] * 2, [0.3] * 2, [-0.7] * 2), "edges"),
    ([0.0, 1.0, 2.0], ([2.0], [0.04, 0.04], [0.3, 0.3], [-0.7, -0.7]), "kappas"),
])
def test_make_term_params_raises_as_reference(edges, lists, match):
    with pytest.raises(ValueError, match=match):
        jt.make_term_params(edges, *lists, 0.04)
    with pytest.raises(ValueError, match=match):
        tt.make_term_params(edges, *lists, 0.04, device="cpu")


def test_cf_reduced_extra_matches_reference(jp, rng):
    u = rng.uniform(0.0, 40.0, 23) - 1j * rng.uniform(0.0, 2.0, 23)
    Tm = np.array([[0.2], [0.5], [0.9], [1.7], [3.0]])
    want = np.asarray(jp.cf_reduced_extra(u, Tm, np.float64, np.complex128))
    got = _tp(jp).cf_reduced_extra(torch.as_tensor(u), interop.tensor(Tm), F64, C128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-14)


@pytest.mark.parametrize("maturity", [0.3, 0.5, 1.2, 3.0])
@pytest.mark.parametrize("is_call", [True, False])
def test_price_term_heston_matches_reference(jp, maturity, is_call):
    want = np.asarray(jt.price_term_heston(jp, K, maturity, S0, R, Q, is_call))
    got = tt.price_term_heston(_tp(jp), interop.tensor(K), interop.tensor(maturity), S0, R,
                               Q, is_call)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)


def test_other_pricers_take_the_hook(jp):
    T = np.array([0.3, 0.8, 1.5, 2.5] * 3)
    Ks = np.linspace(80.0, 120.0, 12)
    want = np.asarray(jh.price_carr_madan_gl(jp, Ks, T, S0, R, Q))
    got = th.price_carr_madan_gl(_tp(jp), interop.tensor(Ks), interop.tensor(T), S0, R, Q)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)


def test_maturity_past_the_last_edge_raises(jp):
    with pytest.raises(ValueError, match="edges"):
        jt.price_term_heston(jp, K, 3.5, S0, R, Q)
    with pytest.raises(ValueError, match="edges"):
        tt.price_term_heston(_tp(jp), interop.tensor(K), interop.tensor(3.5), S0, R, Q)


def test_equal_intervals_are_heston():
    """The glued CF of identical intervals is the constant-parameter CF."""
    p = tt.make_term_params([0.0, 0.4, 1.1, 2.0], [2.0] * 3, [0.04] * 3, [0.3] * 3,
                            [-0.7] * 3, 0.04, device="cpu", dtype=F64)
    heston = th.HestonParams(*(interop.tensor(v) for v in (2.0, 0.04, 0.3, -0.7, 0.04)))
    for T in (0.3, 1.0, 2.0):
        np.testing.assert_allclose(
            tt.price_term_heston(p, interop.tensor(K), interop.tensor(T), S0, R, Q).numpy(),
            th.price_accurate(heston, interop.tensor(K), interop.tensor(T), S0, R, Q).numpy(),
            rtol=1e-10, atol=1e-10)


def test_single_interval_is_heston():
    p = tt.make_term_params([0.0, 5.0], [1.5], [0.05], [0.4], [-0.6], 0.03, device="cpu",
                            dtype=F64)
    heston = th.HestonParams(*(interop.tensor(v) for v in (1.5, 0.05, 0.4, -0.6, 0.03)))
    np.testing.assert_allclose(
        tt.price_term_heston(p, interop.tensor(K), interop.tensor(1.0), S0, R, Q).numpy(),
        th.price_accurate(heston, interop.tensor(K), interop.tensor(1.0), S0, R, Q).numpy(),
        rtol=1e-12, atol=1e-12)
