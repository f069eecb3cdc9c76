"""The Black-Scholes Greeks, barrier, digital and touch prices of the port
held against the JAX package.

The same seeded grid of spot, strike, maturity, vol and call/put flags
goes through ``pde_tpu.models.black_scholes`` (x64, as the suite runs it)
and ``pde_tpu_torch.models.black_scholes`` (float64 on the CPU).  Barriers
are taken up and down, in and out, with strikes on both sides of the
barrier and spots already beyond it (knocked).  Gate: 1e-10 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.models import black_scholes as jbs
from pde_tpu_torch import interop
from pde_tpu_torch.models import black_scholes as tbs

R, Q = 0.05, 0.02
ATOL = 1e-10
BARRIER_TYPES = ["up-and-out", "up-and-in", "down-and-out", "down-and-in"]


@pytest.fixture(scope="module")
def grid():
    rng = np.random.default_rng(20)
    n = 64
    return dict(spot=rng.uniform(60.0, 140.0, n), strike=rng.uniform(60.0, 140.0, n),
                maturity=rng.uniform(0.05, 2.5, n), vol=rng.uniform(0.08, 0.7, n),
                is_call=rng.uniform(size=n) < 0.5)


def _both(g, *names):
    """(jax arrays, torch tensors) of the grid's columns ``names``."""
    return ([jnp.asarray(g[k]) for k in names],
            [interop.tensor(g[k]) if g[k].dtype != bool else torch.as_tensor(g[k])
             for k in names])


def _close(got, want):
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["delta", "theta", "rho"])
@pytest.mark.parametrize("flag", ["grid", True, False])
def test_flagged_greeks_match_reference(grid, name, flag):
    (S, K, T, v, c), (tS, tK, tT, tv, tc) = _both(
        grid, "spot", "strike", "maturity", "vol", "is_call")
    jc, tc = (c, tc) if flag == "grid" else (flag, flag)
    want = getattr(jbs, name)(S, K, R, Q, T, v, jc)
    _close(getattr(tbs, name)(tS, tK, R, Q, tT, tv, tc), want)


def test_gamma_matches_reference(grid):
    (S, K, T, v), (tS, tK, tT, tv) = _both(grid, "spot", "strike", "maturity", "vol")
    _close(tbs.gamma(tS, tK, R, Q, tT, tv), jbs.gamma(S, K, R, Q, T, v))


def test_greeks_dict_matches_reference(grid):
    (S, K, T, v, c), (tS, tK, tT, tv, tc) = _both(
        grid, "spot", "strike", "maturity", "vol", "is_call")
    want = jbs.greeks(S, K, R, Q, T, v, c)
    got = tbs.greeks(tS, tK, R, Q, tT, tv, tc)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


def test_greeks_broadcast_scalar_spot_over_strikes(grid):
    """A scalar spot against a strike vector, tensor rate: shapes broadcast."""
    K = grid["strike"]
    want = jbs.delta(100.0, jnp.asarray(K), 0.03, 0.0, 1.0, 0.2, True)
    got = tbs.delta(torch.tensor(100.0, dtype=torch.float64), interop.tensor(K),
                    0.03, 0.0, 1.0, 0.2, True)
    assert tuple(got.shape) == (len(K),)
    _close(got, want)


@pytest.fixture(scope="module")
def barrier_book():
    """Spots around 100; barriers above (up) and below (down) the spot with
    strikes on both sides of each, and a quarter of the spots already
    beyond their barrier."""
    rng = np.random.default_rng(21)
    n = 96
    spot = rng.uniform(85.0, 115.0, n)
    up = spot * rng.uniform(1.05, 1.4, n)
    down = spot * rng.uniform(0.6, 0.95, n)
    knocked = rng.uniform(size=n) < 0.25
    up = np.where(knocked, spot * 0.97, up)
    down = np.where(knocked, spot * 1.03, down)
    strike = spot * rng.uniform(0.6, 1.5, n)
    return dict(spot=spot, strike=strike, up=up, down=down,
                maturity=rng.uniform(0.1, 2.0, n), vol=rng.uniform(0.1, 0.5, n),
                is_call=rng.uniform(size=n) < 0.5, knocked=knocked)


@pytest.mark.parametrize("barrier_type", BARRIER_TYPES)
def test_barrier_price_matches_reference(barrier_book, barrier_type):
    b = dict(barrier_book)
    b["barrier"] = b["up"] if barrier_type.startswith("up") else b["down"]
    strikes_above = b["strike"] > b["barrier"]
    assert strikes_above.any() and (~strikes_above).any()
    assert b["knocked"].any() and (~b["knocked"]).any()
    (S, K, B, T, v, c), (tS, tK, tB, tT, tv, tc) = _both(
        b, "spot", "strike", "barrier", "maturity", "vol", "is_call")
    want = jbs.barrier_price(S, K, B, R, Q, T, v, barrier_type=barrier_type, is_call=c)
    got = tbs.barrier_price(tS, tK, tB, R, Q, tT, tv, barrier_type=barrier_type,
                            is_call=tc)
    _close(got, want)
    knocked_value = 0.0 if barrier_type.endswith("out") else tbs.price(
        tS, tK, R, Q, tT, tv, tc)[torch.as_tensor(b["knocked"])]
    np.testing.assert_allclose(got[torch.as_tensor(b["knocked"])].numpy(),
                               np.asarray(knocked_value), rtol=0, atol=ATOL)


@pytest.mark.parametrize("direction", ["up", "down"])
def test_barrier_in_plus_out_is_vanilla(barrier_book, direction):
    b = barrier_book
    args = (interop.tensor(b["spot"]), interop.tensor(b["strike"]),
            interop.tensor(b[direction]), R, Q, interop.tensor(b["maturity"]),
            interop.tensor(b["vol"]))
    c = torch.as_tensor(b["is_call"])
    total = (tbs.barrier_price(*args, barrier_type=f"{direction}-and-in", is_call=c)
             + tbs.barrier_price(*args, barrier_type=f"{direction}-and-out", is_call=c))
    vanilla = tbs.price(args[0], args[1], R, Q, args[5], args[6], c)
    np.testing.assert_allclose(total.numpy(), vanilla.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("bad", ["sideways-and-out", "up-and-around", "upandout", ""])
def test_bad_barrier_type_raises_as_reference(bad):
    with pytest.raises(ValueError, match="unknown barrier_type"):
        jbs.barrier_price(100.0, 100.0, 120.0, R, Q, 1.0, 0.2, barrier_type=bad)
    with pytest.raises(ValueError, match="unknown barrier_type"):
        tbs.barrier_price(torch.tensor(100.0, dtype=torch.float64), 100.0, 120.0, R, Q,
                          1.0, 0.2, barrier_type=bad)


@pytest.mark.parametrize("kind", ["cash", "asset"])
@pytest.mark.parametrize("flag", ["grid", True, False])
def test_digital_price_matches_reference(grid, kind, flag):
    (S, K, T, v, c), (tS, tK, tT, tv, tc) = _both(
        grid, "spot", "strike", "maturity", "vol", "is_call")
    jc, tc = (c, tc) if flag == "grid" else (flag, flag)
    want = jbs.digital_price(S, K, R, Q, T, v, jc, kind=kind)
    _close(tbs.digital_price(tS, tK, R, Q, tT, tv, tc, kind=kind), want)


@pytest.mark.parametrize("bad", ["bond", "Cash", ""])
def test_bad_digital_kind_raises_as_reference(bad):
    with pytest.raises(ValueError, match="kind must be"):
        jbs.digital_price(100.0, 100.0, R, Q, 1.0, 0.2, kind=bad)
    with pytest.raises(ValueError, match="kind must be"):
        tbs.digital_price(torch.tensor(100.0, dtype=torch.float64), 100.0, R, Q, 1.0, 0.2,
                          kind=bad)


def _touch_inputs(barrier_book):
    """Barriers above, below and exactly at the spot."""
    b = barrier_book
    n = len(b["spot"])
    barrier = np.where(np.arange(n) % 3 == 0, b["up"],
                       np.where(np.arange(n) % 3 == 1, b["down"], b["spot"]))
    return dict(spot=b["spot"], barrier=barrier, maturity=b["maturity"], vol=b["vol"])


def test_no_touch_prob_matches_reference(barrier_book):
    (S, B, T, v), (tS, tB, tT, tv) = _both(
        _touch_inputs(barrier_book), "spot", "barrier", "maturity", "vol")
    got = tbs.no_touch_prob(tS, tB, R, Q, tT, tv)
    _close(got, jbs.no_touch_prob(S, B, R, Q, T, v))
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("touch", [True, False])
def test_touch_price_matches_reference(barrier_book, touch):
    (S, B, T, v), (tS, tB, tT, tv) = _both(
        _touch_inputs(barrier_book), "spot", "barrier", "maturity", "vol")
    _close(tbs.touch_price(tS, tB, R, Q, tT, tv, touch=touch),
           jbs.touch_price(S, B, R, Q, T, v, touch=touch))
