"""``pde_tpu_torch.models.digital`` held against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU:
the Gil-Pelaez probabilities and the cash/asset digitals, single and
grouped, under Heston and Bates, at 1e-8.  The JAX suite's oracle is kept:
``european_from_digitals`` is ``price_accurate``.  The quadrature stretch is
detached, so gradients match ``jax.grad``'s (``stop_gradient``).
"""

import jax
import numpy as np
import pytest
import torch

from pde_tpu.models import bates as jb
from pde_tpu.models import digital as jd
from pde_tpu.models import heston as jh
from pde_tpu_torch import interop
from pde_tpu_torch.models import digital as td
from pde_tpu_torch.models import heston as th

S0, R, Q = 100.0, 0.05, 0.02
F64 = torch.float64
HESTON = jh.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
BATES = jb.BatesParams(2.0, 0.04, 0.3, -0.7, 0.04, 0.6, -0.08, 0.18)
PARAMS = {"heston": (HESTON, interop.heston_params(HESTON)),
          "bates": (BATES, interop.bates_params(BATES))}


@pytest.fixture(scope="module")
def book():
    rng = np.random.default_rng(5)
    K = np.sort(rng.uniform(60.0, 140.0, 32))
    T = rng.choice([0.02, 0.1, 0.5, 1.0, 2.0], 32)
    return K, T, rng.uniform(size=32) < 0.5


def _t(x):
    return interop.tensor(x)


@pytest.mark.parametrize("model", sorted(PARAMS))
def test_tail_scale_matches_reference(book, model):
    jp, tp = PARAMS[model]
    _, T, _ = book
    np.testing.assert_allclose(td._tail_scale(tp, _t(T), F64).numpy(),
                               np.asarray(jd._tail_scale(jp, T, np.float64)), rtol=1e-14)
    plain = jh.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)._asdict()
    del plain["kappa"]
    assert float(td._tail_scale(type("P", (), plain)(), _t(0.5), F64)) == 1.0


@pytest.mark.parametrize("model", sorted(PARAMS))
def test_probabilities_match_reference(book, model):
    jp, tp = PARAMS[model]
    K, T, _ = book
    want = jd.probabilities(jp, K, T, S0, R, Q)
    got = td.probabilities(tp, _t(K), _t(T), S0, R, Q)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)


@pytest.mark.parametrize("model", sorted(PARAMS))
@pytest.mark.parametrize("kind", ["cash", "asset"])
def test_price_matches_reference(book, model, kind):
    jp, tp = PARAMS[model]
    K, T, calls = book
    want = np.asarray(jd.price(jp, K, T, S0, R, Q, is_call=calls, kind=kind))
    got = td.price(tp, _t(K), _t(T), S0, R, Q, is_call=torch.as_tensor(calls), kind=kind)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)


@pytest.mark.parametrize("model", sorted(PARAMS))
@pytest.mark.parametrize("kind", ["cash", "asset"])
def test_price_grouped_matches_reference(book, model, kind):
    jp, tp = PARAMS[model]
    K, T, calls = book
    unique_T, t_idx = jh.group_maturities(T)
    tt_idx, tuT = interop.grouping(t_idx, unique_T)
    want = np.asarray(jd.price_grouped(jp, K, t_idx, unique_T, S0, R, Q, is_call=calls,
                                       kind=kind))
    got = td.price_grouped(tp, _t(K), tt_idx, tuT, S0, R, Q, is_call=torch.as_tensor(calls),
                           kind=kind)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)
    single = td.price(tp, _t(K), _t(T), S0, R, Q, is_call=torch.as_tensor(calls), kind=kind)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-12)


def test_prices_from_probs_matches_reference(book):
    K, T, calls = book
    p1, p2 = jd.probabilities(HESTON, K, T, S0, R, Q)
    want = jd.prices_from_probs(p1, p2, K, T, S0, R, Q, is_call=calls)
    got = td.prices_from_probs(_t(p1), _t(p2), _t(K), _t(T), S0, R, Q,
                               is_call=torch.as_tensor(calls))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)


@pytest.mark.parametrize("is_call", [True, False])
def test_european_from_digitals(book, is_call):
    """Reference parity, and the JAX suite's identity against the vanilla
    pricer."""
    K, T, _ = book
    want = np.asarray(jd.european_from_digitals(BATES, K, T, S0, R, Q, is_call=is_call))
    tp = PARAMS["bates"][1]
    got = td.european_from_digitals(tp, _t(K), _t(T), S0, R, Q, is_call=is_call)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)
    keep = T >= 0.1  # the vanilla's composite rule is tuned for T >= ~0.1
    vanilla = th.price_accurate(tp, _t(K[keep]), _t(T[keep]), S0, R, Q, is_call)
    np.testing.assert_allclose(got.numpy()[keep], vanilla.numpy(), atol=1e-6)


def test_cash_call_and_put_sum_to_the_discount(book):
    K, T, _ = book
    tp = PARAMS["heston"][1]
    call = td.price(tp, _t(K), _t(T), S0, R, Q, True)
    put = td.price(tp, _t(K), _t(T), S0, R, Q, False)
    np.testing.assert_allclose((call + put).numpy(), np.exp(-R * T), atol=1e-14)
    assert bool(((call >= 0.0) & (call <= torch.exp(-R * _t(T)))).all())


def test_kind_is_checked():
    with pytest.raises(ValueError, match="kind"):
        td.price(PARAMS["heston"][1], _t(100.0), _t(1.0), S0, kind="both")
    with pytest.raises(ValueError, match="kind"):
        td.price_grouped(PARAMS["heston"][1], _t([100.0]), torch.tensor([0]), _t([1.0]),
                         S0, kind="both")


def test_spot_gradient_matches_jax_grad():
    """The detached stretch leaves d price / d spot the reference's."""
    K, T = np.array([90.0, 100.0, 110.0]), np.array([0.05, 0.5, 1.5])
    want = jax.grad(lambda s: jd.price(HESTON, K, T, s, R, Q).sum())(S0)
    spot = _t(S0).requires_grad_(True)
    td.price(PARAMS["heston"][1], _t(K), _t(T), spot, R, Q).sum().backward()
    np.testing.assert_allclose(float(spot.grad), float(want), rtol=1e-9)
