"""The port's Heston QE Monte Carlo engine (``pde_tpu_torch/models/
heston_mc.py``) held against ``pde_tpu`` (x64) on the CPU.

JAX's threefry and torch's Philox streams differ, so the parity tests run
the port on the reference's own draws: ``jax_key_draws.JaxKey(key)``
answers each split and draw the port asks for with the ``jax.random`` call
the reference makes on that key.  Gates, each with its reason:
- every simulator field, every pricer's (price, stderr) and every Greek:
  1e-10 relative in float64 (the same arithmetic on the same draws; the
  path and payoff reductions sum in another order, ~1e-15, and a float64
  variance near its floor keeps ~1e-13 of its digits through 16 steps);
- the draws-made-first Greeks: the same gate, through ``torch.func.jacfwd``
  against ``jax.jacfwd``;
- a ``torch.Generator``'s own paths (Philox): the reference's statistical
  gates (the discounted spot a martingale within 4 s.e.);
- a replay of a generator: bit-equal across runs, and its float32 replay
  within 1e-4 relative of its float64 run (16 float32 steps).
Sizes: at most 4096 paths x 16 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey

from pde_tpu.models import heston_mc as jmc
from pde_tpu.models.heston import HestonParams as JParams
from pde_tpu_torch.models import heston_mc as tmc
from pde_tpu_torch.models.heston import HestonParams as TParams

F64 = torch.float64
CPU = torch.device("cpu")
FIELDS = (2.0, 0.04, 0.3, -0.7, 0.04)
JP, TP = JParams(*FIELDS), TParams(*FIELDS)
S0 = torch.tensor(100.0, dtype=F64)
KEY = jax.random.PRNGKey(3)
KW = dict(n_steps=16, n_paths=4096, rate=0.05, dividend=0.02)
REL = dict(rtol=1e-10, atol=0.0)


def _close(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want), **REL)


SIMULATIONS = {
    "pseudo": dict(),
    "barrier_up": dict(barrier=120.0),
    "barrier_down": dict(barrier=85.0, barrier_direction="down"),
    "sobol": dict(sampler="sobol", antithetic=False),
    "plain_drift_no_antithetic": dict(antithetic=False, martingale_correction=False),
}


@pytest.mark.parametrize("case", sorted(SIMULATIONS))
def test_simulate_qe_matches_reference(case):
    kw = SIMULATIONS[case]
    want = jmc.simulate_qe(JP, 100.0, 1.0, KEY, **KW, **kw)
    got = tmc.simulate_qe(TP, S0, 1.0, JaxKey(KEY), **KW, **kw)
    assert got.spot.dtype == F64 and got.spot.shape == (4096,)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("sampler", ["pseudo", "sobol"])
def test_simulate_qe_paths_matches_reference(sampler):
    kw = dict(sampler=sampler, antithetic=sampler == "pseudo")
    want = jmc.simulate_qe_paths(JP, 100.0, 1.0, KEY, **KW, **kw)
    got = tmc.simulate_qe_paths(TP, S0, 1.0, JaxKey(KEY), **KW, **kw)
    assert got[0].shape == (16, 4096)
    for g, w in zip(got, want):
        _close(g, w)


STRIKES = [90.0, 100.0, 110.0]
PRICERS = {
    "european": lambda m, p, k, s: m.price_european_mc(p, STRIKES, 1.0, s, k, **KW),
    "european_put_scalar": lambda m, p, k, s: m.price_european_mc(
        p, 97.3, 1.0, s, k, is_call=False, control_variate=False, **KW),
    "european_sobol": lambda m, p, k, s: m.price_european_mc(
        p, STRIKES, 1.0, s, k, sampler="sobol", antithetic=False, n_replicates=4, **KW),
    "asian_put": lambda m, p, k, s: m.price_asian_mc(p, 100.0, 1.0, s, k, is_call=False, **KW),
    "barrier_up_and_out": lambda m, p, k, s: m.price_barrier_mc(
        p, 100.0, 120.0, 1.0, s, k, **KW),
    "barrier_down_and_in_continuous": lambda m, p, k, s: m.price_barrier_mc(
        p, 100.0, 85.0, 1.0, s, k, barrier_type="down-and-in", is_call=False,
        continuity_correction=True, **KW),
    "digital_asset": lambda m, p, k, s: m.price_digital_mc(p, STRIKES, 1.0, s, k, kind="asset",
                                                           **KW),
    "digital_cash_put": lambda m, p, k, s: m.price_digital_mc(p, 100.0, 1.0, s, k,
                                                              is_call=False, **KW),
    "one_touch": lambda m, p, k, s: m.price_touch_mc(p, 115.0, 1.0, s, k, **KW),
    "no_touch_discrete": lambda m, p, k, s: m.price_touch_mc(
        p, 88.0, 1.0, s, k, touch=False, continuity_correction=False, **KW),
    "lookback_floating": lambda m, p, k, s: m.price_lookback_mc(p, 1.0, s, k, **KW),
    "lookback_fixed_put": lambda m, p, k, s: m.price_lookback_mc(
        p, 1.0, s, k, strike=95.0, is_call=False, **KW),
    "path_payoff_sobol": lambda m, p, k, s: m.price_path_payoff_mc(
        p, lambda paths: paths.s_max - paths.s_min, s, 1.0, k, sampler="sobol",
        antithetic=False, n_replicates=4, **KW),
    "forward_start": lambda m, p, k, s: m.price_forward_start_mc(
        p, [0.9, 1.0, 1.1], 0.5, 1.0, s, k, **KW),
    "cliquet": lambda m, p, k, s: m.price_cliquet_mc(
        p, 1.0, s, k, n_periods=4, n_steps=16, n_paths=4096, rate=0.05, dividend=0.02,
        global_cap=0.2),
}


@pytest.mark.parametrize("case", sorted(PRICERS))
def test_pricers_match_reference(case):
    want = PRICERS[case](jmc, JP, KEY, 100.0)
    got = PRICERS[case](tmc, TP, JaxKey(KEY), S0)
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        _close(g, w)


def test_greeks_match_reference():
    want = jmc.greeks_european_mc(JP, jnp.array(STRIKES), 1.0, 100.0, KEY, **KW)
    got = tmc.greeks_european_mc(TP, STRIKES, 1.0, S0, JaxKey(KEY), **KW)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == (3,), name
        _close(got[name], want[name])


def test_greeks_of_a_scalar_strike_on_a_generator_draw_first():
    """A generator's draws are made before ``jacfwd`` (a random op under it
    raises): the Greeks come out, scalar-shaped, and delta is the same
    finite difference of the same estimator on the same draws (the
    reference's ``test_greeks_mc_ad_matches_fd_of_same_estimator``)."""
    kw = dict(n_steps=8, n_paths=2048, rate=0.03)
    g = tmc.greeks_european_mc(TP, 100.0, 1.0, S0, torch.Generator().manual_seed(1), **kw)
    assert all(v.shape == () for v in g.values())
    h = 1e-3
    up, dn = (tmc.price_european_mc(TP, 100.0, 1.0, S0 + d, torch.Generator().manual_seed(1),
                                    **kw)[0] for d in (h, -h))
    assert abs(float(g["delta"]) - float((up - dn) / (2 * h))) < 1e-6
    assert 0.3 < float(g["delta"]) < 0.8


def test_generator_paths_are_a_martingale():
    """The port's own (Philox) paths: e^{-(r-q)T} E[S_T] within 4 s.e. of
    S0 (the reference's test_martingale_property)."""
    paths = tmc.simulate_qe(TP, S0, 1.0, torch.Generator().manual_seed(0), **KW)
    x = torch.exp(torch.tensor(-(0.05 - 0.02), dtype=F64)) * paths.spot
    se = float(x.std() / 4096**0.5)
    assert abs(float(x.mean()) - 100.0) < 4 * se
    assert bool((paths.s_max >= paths.spot).all()) and bool((paths.s_min <= paths.spot).all())


def test_replay_hands_back_the_same_draws():
    """A replay of a generator draws once: two runs on it are equal, its
    float32 replay stays within 1e-4 relative of the float64 run, and the
    generator advanced only once."""
    g = torch.Generator().manual_seed(7)
    replay = tmc._Replay(tmc._draws(g, CPU))
    kw = dict(n_steps=16, n_paths=512, rate=0.05, dividend=0.02)
    a = tmc.simulate_qe(TP, S0, 1.0, replay, **kw)
    b = tmc.simulate_qe(TP, S0, 1.0, replay, **kw)
    torch.testing.assert_close(a.spot, b.spot, rtol=0.0, atol=0.0)
    c = tmc.simulate_qe(TP, torch.tensor(100.0), 1.0, replay, **kw)
    assert c.spot.dtype == torch.float32
    torch.testing.assert_close(c.spot.double(), a.spot, rtol=1e-4, atol=0.0)
    fresh = tmc.simulate_qe(TP, S0, 1.0, torch.Generator().manual_seed(7), **kw)
    torch.testing.assert_close(fresh.spot, a.spot, rtol=0.0, atol=0.0)
    with pytest.raises(ValueError, match="split"):
        tmc.simulate_qe(TP, S0, 1.0, replay, **{**kw, "n_steps": 8})


def test_sobol_replicates_see_their_own_paths():
    """Each replicate's payoff call sees (m,) fields, as under the
    reference's vmap over replicate keys."""
    seen = []

    def payoff(paths):
        seen.append(paths.spot.shape)
        return paths.spot

    tmc.price_path_payoff_mc(TP, payoff, S0, 1.0, torch.Generator().manual_seed(0),
                             n_steps=4, n_paths=256, antithetic=False, sampler="sobol",
                             n_replicates=4)
    assert seen == [(64,)] * 4


@pytest.mark.parametrize("call,match", [
    (lambda g: tmc.simulate_qe(TP, S0, 1.0, g, n_steps=4, n_paths=63), "even"),
    (lambda g: tmc.simulate_qe(TP, S0, 1.0, g, n_steps=4, n_paths=64, sampler="sobol"),
     "antithetic"),
    (lambda g: tmc.simulate_qe(TP, S0, 1.0, g, n_steps=4, n_paths=64, antithetic=False,
                               sampler="halton"), "sampler"),
    (lambda g: tmc.price_european_mc(TP, 100.0, 1.0, S0, g, n_steps=4, n_paths=100,
                                     antithetic=False, sampler="sobol"), "divisible"),
    (lambda g: tmc.price_barrier_mc(TP, 100.0, 120.0, 1.0, S0, g, barrier_type="sideways"),
     "barrier_type"),
    (lambda g: tmc.price_forward_start_mc(TP, 1.0, 0.3, 1.0, S0, g, n_steps=8, n_paths=64),
     "grid"),
    (lambda g: tmc.price_digital_mc(TP, 100.0, 1.0, S0, g, kind="bond"), "kind"),
])
def test_bad_arguments_raise_as_the_reference(call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.Generator())


def test_fixing_indices_match_reference():
    assert (tmc._fixing_indices(64, 2.0, [0.5, 1.0, 2.0])
            == jmc._fixing_indices(64, 2.0, [0.5, 1.0, 2.0]))
