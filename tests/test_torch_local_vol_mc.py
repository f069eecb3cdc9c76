"""Monte Carlo under a local-vol surface (``pde_tpu_torch.models.local_vol``
``simulate_local_vol`` and ``lv_simulate_fn``) held against ``pde_tpu``
(x64) on the CPU.

The port runs on the reference's own normals (``jax_key_draws.JaxKey``:
``n_steps`` step keys, one normal draw each).  Gates, each with its
reason:
- every ``MCPaths`` field, and the Heston estimators' ``(price, stderr)``
  through ``lv_simulate_fn`` with ``params=None``: 1e-10 relative in
  float64 (the same arithmetic on the same draws; the payoff reductions
  sum in another order, ~1e-15);
- the reference suite's own checks on the port's generator (Philox): a
  flat surface prices the Black-Scholes call within 4 s.e. + 0.05, and a
  down-and-out sits between 0 and its vanilla on the same draws.
Sizes: at most 4096 paths x 16 steps for parity, 2^14 x 32 otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey

from pde_tpu.models import heston_mc as jmc
from pde_tpu.models import local_vol as jlv
from pde_tpu_torch import interop
from pde_tpu_torch.models import black_scholes as tbs
from pde_tpu_torch.models import heston_mc as tmc
from pde_tpu_torch.models import local_vol as tlv

F64 = torch.float64
CPU = torch.device("cpu")
S0, R, Q = 100.0, 0.04, 0.01
KEY = jax.random.PRNGKey(5)
KW = dict(n_steps=16, n_paths=4096, rate=R, dividend=Q)
REL = dict(rtol=1e-10, atol=0.0)
KS = np.exp(np.linspace(np.log(60.0), np.log(170.0), 12))
TS = np.array([0.05, 0.15, 0.3, 0.6, 1.2])
# a smile and term structure: higher vol at low strikes, flattening in T
GRID = 0.18 + 0.12 * (np.log(100.0 / KS)[None, :] + 0.6).clip(0.0) / (1.0 + TS[:, None])


@pytest.fixture(scope="module")
def surfaces():
    j = jlv.SurfaceInterpolator(jnp.asarray(KS), jnp.asarray(TS), jnp.asarray(GRID))
    return j, interop.surface_interpolator(j)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want), **REL)


@pytest.mark.parametrize("antithetic", [True, False])
def test_simulate_local_vol_matches_reference(surfaces, antithetic):
    j, t = surfaces
    want = jlv.simulate_local_vol(j, S0, 0.75, KEY, antithetic=antithetic, **KW)
    got = tlv.simulate_local_vol(t, torch.tensor(S0, dtype=F64), 0.75, JaxKey(KEY),
                                 antithetic=antithetic, **KW)
    assert got.spot.dtype == F64 and got.spot.shape == (4096,) and got.survival is None
    for g, w in zip(got[:5], want[:5]):
        _close(g, w)


def test_closure_surface_matches_reference():
    def j_fn(s, t):
        return 0.2 + 0.1 * jnp.exp(-s / 100.0) * (1.0 + t)

    def t_fn(s, t):
        return 0.2 + 0.1 * torch.exp(-s / 100.0) * (1.0 + t)

    want = jlv.simulate_local_vol(j_fn, S0, 0.5, KEY, **KW)
    got = tlv.simulate_local_vol(t_fn, S0, torch.tensor(0.5, dtype=F64), JaxKey(KEY), **KW)
    for g, w in zip(got[:5], want[:5]):
        _close(g, w)


ESTIMATORS = {
    "european_cv": lambda m, fn, k, s: m.price_european_mc(
        None, np.array([90.0, 100.0, 115.0]), 0.75, s, k, simulate_fn=fn, **KW),
    "european_put_raw": lambda m, fn, k, s: m.price_european_mc(
        None, 97.0, 0.75, s, k, is_call=False, control_variate=False, simulate_fn=fn, **KW),
    "barrier_down_and_out": lambda m, fn, k, s: m.price_barrier_mc(
        None, 100.0, 80.0, 0.75, s, k, barrier_type="down-and-out", simulate_fn=fn, **KW),
    "asian": lambda m, fn, k, s: m.price_asian_mc(None, 100.0, 0.75, s, k, simulate_fn=fn,
                                                  **KW),
    "digital_asset": lambda m, fn, k, s: m.price_digital_mc(
        None, np.array([95.0, 105.0]), 0.75, s, k, kind="asset", simulate_fn=fn, **KW),
}


@pytest.mark.parametrize("case", sorted(ESTIMATORS))
def test_estimators_through_lv_simulate_fn_match_reference(surfaces, case):
    j, t = surfaces
    want = ESTIMATORS[case](jmc, jlv.lv_simulate_fn(j), KEY, S0)
    got = ESTIMATORS[case](tmc, tlv.lv_simulate_fn(t), JaxKey(KEY),
                           torch.tensor(S0, dtype=F64))
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        _close(g, w)


def test_flat_surface_prices_black_scholes():
    """tests/test_local_vol.py::TestLocalVolMC on the port's own draws."""
    sig = 0.25
    fn = tlv.lv_simulate_fn(lambda s, t: torch.full_like(s, sig))
    s0 = torch.tensor(S0, dtype=F64)
    price, se = tmc.price_european_mc(None, 100.0, 0.75, s0, torch.Generator().manual_seed(2),
                                      rate=R, dividend=Q, n_steps=32, n_paths=1 << 14,
                                      simulate_fn=fn)
    closed = float(tbs.price(s0, 100.0, R, Q, 0.75, sig))
    assert abs(float(price) - closed) < 4.0 * float(se) + 0.05


def test_knock_out_below_vanilla_on_the_same_draws(surfaces):
    _, t = surfaces
    fn = tlv.lv_simulate_fn(t)
    s0 = torch.tensor(S0, dtype=F64)
    replay = tmc._Replay(tmc._draws(torch.Generator().manual_seed(4), CPU))
    kw = dict(rate=R, dividend=Q, n_steps=32, n_paths=1 << 14, simulate_fn=fn)
    b_px, _ = tmc.price_barrier_mc(None, 100.0, 80.0, 0.5, s0, replay,
                                   barrier_type="down-and-out", **kw)
    v_px, _ = tmc.price_european_mc(None, 100.0, 0.5, s0, replay, control_variate=False, **kw)
    assert 0.0 < float(b_px) < float(v_px)
