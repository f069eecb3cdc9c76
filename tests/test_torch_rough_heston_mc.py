"""The lifted rough-Heston Monte Carlo (``pde_tpu_torch/models/
rough_heston_mc.py``) held against ``pde_tpu`` (x64) on the CPU.

``lift_nodes`` fits 20 exponentials whose nodes span 7 decades: its
weights ``c`` are ill-determined (the float64 weights of two correct
solves differ by up to 2e-5 of their largest, the reference's own float32
weights by 3.6% to 177% of it), while the kernel they fit is determined.
Gates, each with its reason:
- the nodes ``x`` equal; the fitted kernel sum_j c_j e^{-x_j t} at 1e-10
  relative over the fitted range t in [1e-4, 4] (measured ~1e-11; the port
  solves the same ridge least squares by QR, the reference by the normal
  equations);
- float32 (the path dtype off x64): the port's ``c`` no farther from the
  reference's float64 ``c`` than twice the reference's own float32 ``c``
  is, and its kernel no farther than the reference's float32 kernel;
- the simulators and pricers on the reference's own nodes (``lift_nodes``
  answered with the reference's ``(c, x)``) and draws
  (``jax_key_draws.JaxKey``: step keys, then ``(W, B)`` a step): 1e-10
  relative in float64;
- on the port's own nodes: 1e-8 relative (the kernels' 1e-11 differ on
  the fastest factors, felt through 16 steps of the variance);
- the reference suite's checks on the port's generator (Philox): the
  kernel fit within 1e-3 at H = 0.1 and ~1 at H = 1/2, the H = 1/2 engine
  within 4 s.e. + 0.01 of the classic Heston price, sane path statistics,
  the stored and accumulated terminals equal, the American put above its
  European and at least intrinsic deep in the money.
Sizes: at most 4096 paths x 16 steps.
"""

from math import gamma as math_gamma

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey

from pde_tpu.models import rough_heston_mc as jr
from pde_tpu.models.rough_heston import RoughHestonParams as JP
from pde_tpu_torch.models import heston as th
from pde_tpu_torch.models import rough_heston_mc as tr
from pde_tpu_torch.models.heston_mc import _draws, _Replay
from pde_tpu_torch.models.rough_heston import RoughHestonParams as TP

F64 = torch.float64
CPU = torch.device("cpu")
ROUGH = (0.1, 2.0, 0.04, 0.3, -0.7, 0.04)
H12 = (0.5, 2.0, 0.04, 0.3, -0.7, 0.04)
KEY = jax.random.PRNGKey(7)
KW = dict(n_steps=16, n_paths=2048, n_factors=20, rate=0.03, dividend=0.01)
REL = dict(rtol=1e-10, atol=0.0)
T_FIT = np.geomspace(1e-4, 4.0, 97)


def _kernel(c, x, t=T_FIT):
    c, x = (np.asarray(a, dtype=np.float64) for a in (c, x))
    return (c[None, :] * np.exp(-t[:, None] * x[None, :])).sum(1)


@pytest.mark.parametrize("hurst", [0.1, 0.3, 0.5])
def test_lift_nodes_fit_the_reference_kernel(hurst):
    want_c, want_x = jr.lift_nodes(hurst, 20)
    c, x = tr.lift_nodes(torch.tensor(hurst, dtype=F64), 20)
    assert c.dtype == F64 and c.shape == (20,)
    np.testing.assert_array_equal(x.numpy(), np.asarray(want_x))
    np.testing.assert_allclose(_kernel(c, x), _kernel(want_c, want_x), **REL)


@pytest.mark.parametrize("hurst", [0.1, 0.3, 0.5])
def test_float32_lift_weights_within_twice_the_reference_s_own_error(hurst):
    c64, x64 = (np.asarray(a) for a in jr.lift_nodes(hurst, 20))
    ref32, _ = jr.lift_nodes(hurst, 20, dtype=jnp.float32)
    c32, _ = tr.lift_nodes(torch.tensor(hurst, dtype=torch.float32), 20)
    assert c32.dtype == torch.float32

    def off(c):
        return np.max(np.abs(np.asarray(c, np.float64) - c64)) / np.max(np.abs(c64))

    assert off(c32.numpy()) <= 2.0 * off(ref32)
    k64 = _kernel(c64, x64)

    def k_off(c):
        return np.max(np.abs(_kernel(c, x64) / k64 - 1.0))

    assert k_off(c32.numpy()) <= k_off(ref32)


@pytest.fixture
def reference_nodes(monkeypatch):
    """``lift_nodes`` answered with the reference's (c, x) in float64."""
    def nodes(hurst, n_factors=20, *args, dtype=None, device=None):
        c, x = jr.lift_nodes(float(hurst), n_factors)
        return (torch.tensor(np.asarray(c), dtype=dtype, device=device or CPU),
                torch.tensor(np.asarray(x), dtype=dtype, device=device or CPU))

    monkeypatch.setattr(tr, "lift_nodes", nodes)


def _close(got, want, **gate):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want),
                               **(gate or REL))


@pytest.mark.parametrize("antithetic", [True, False])
def test_simulate_lifted_matches_reference(reference_nodes, antithetic):
    want = jr.simulate_lifted(JP(*ROUGH), 100.0, 0.5, KEY, antithetic=antithetic, **KW)
    got = tr.simulate_lifted(TP(*ROUGH), torch.tensor(100.0, dtype=F64), 0.5, JaxKey(KEY),
                             antithetic=antithetic, **KW)
    assert got.spot.dtype == F64 and got.spot.shape == (2048,)
    for g, w in zip(got[:5], want[:5]):
        _close(g, w)


def test_simulate_lifted_paths_matches_reference(reference_nodes):
    want = jr.simulate_lifted_paths(JP(*ROUGH), 100.0, 0.5, KEY, **KW)
    got = tr.simulate_lifted_paths(TP(*ROUGH), torch.tensor(100.0, dtype=F64), 0.5,
                                   JaxKey(KEY), **KW)
    assert got[0].shape == (16, 2048)
    for g, w in zip(got, want):
        _close(g, w)


PRICERS = {
    "european_ladder": lambda m, p, k, s: m.price_european_rough_mc(
        p, np.array([90.0, 100.0, 110.0]), 0.5, s, k, **KW),
    "european_put_scalar": lambda m, p, k, s: m.price_european_rough_mc(
        p, 97.0, 0.5, s, k, is_call=False, **KW),
    "american_put": lambda m, p, k, s: m.price_american_rough_lsm(
        p, 100.0, 0.5, s, k, rate=0.05, n_steps=16, n_paths=2048, n_factors=20),
    "american_put_deep_itm": lambda m, p, k, s: m.price_american_rough_lsm(
        p, 125.0, 0.5, s, k, rate=0.05, n_steps=16, n_paths=2048, n_factors=20),
}


@pytest.mark.parametrize("case", sorted(PRICERS))
def test_pricers_match_reference(reference_nodes, case):
    want = PRICERS[case](jr, JP(*ROUGH), KEY, 100.0)
    got = PRICERS[case](tr, TP(*ROUGH), JaxKey(KEY), torch.tensor(100.0, dtype=F64))
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        _close(g, w)


def test_own_nodes_stay_near_the_reference():
    want = jr.simulate_lifted(JP(*ROUGH), 100.0, 0.5, KEY, **KW)
    got = tr.simulate_lifted(TP(*ROUGH), torch.tensor(100.0, dtype=F64), 0.5, JaxKey(KEY),
                             **KW)
    for g, w in zip(got[:5], want[:5]):
        _close(g, w, rtol=1e-8, atol=0.0)


def test_kernel_fit_accuracy_and_constant_kernel_at_h_half():
    """tests/test_rough_heston_mc.py::TestLiftNodes on the port."""
    c, x = tr.lift_nodes(torch.tensor(0.1, dtype=F64), 20)
    for t in (1e-3, 1e-2, 0.1, 0.5, 2.0):
        k_true = t ** (0.6 - 1.0) / math_gamma(0.6)
        assert abs(float(_kernel(c, x, np.array([t]))[0]) / k_true - 1.0) < 1e-3, t
    c, x = tr.lift_nodes(torch.tensor(0.5, dtype=F64), 20)
    for t in (1e-3, 0.1, 1.0):
        assert abs(float(_kernel(c, x, np.array([t]))[0]) - 1.0) < 1e-3


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_h_half_collapses_to_classic_heston():
    strikes = torch.tensor([90.0, 100.0, 110.0], dtype=F64)
    cf = th.price_accurate(th.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04), strikes,
                           torch.full((3,), 0.25, dtype=F64), 100.0, 0.03, 0.0)
    mc, se = tr.price_european_rough_mc(TP(*H12), strikes, 0.25, torch.tensor(100.0, dtype=F64),
                                        _gen(7), rate=0.03, n_steps=16, n_paths=4096)
    assert bool(((mc - cf).abs() < 4.0 * se + 0.01).all()), (mc, cf, se)


def test_path_statistics_stored_terminal_and_american_bounds():
    s0 = torch.tensor(100.0, dtype=F64)
    kw = dict(n_steps=16, n_paths=2048)
    replay = _Replay(_draws(_gen(1), CPU))
    paths = tr.simulate_lifted(TP(*ROUGH), s0, 0.5, replay, **kw)
    assert bool((paths.s_max >= paths.spot).all() and (paths.s_min <= paths.spot).all())
    assert bool((paths.s_max >= 100.0).all() and (paths.variance >= 0.0).all())
    s_path, v_path = tr.simulate_lifted_paths(TP(*ROUGH), s0, 0.5, replay, **kw)
    np.testing.assert_allclose(s_path[-1].numpy(), paths.spot.numpy(), rtol=1e-12)
    np.testing.assert_allclose(v_path[-1].numpy(), paths.variance.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="even"):
        tr.simulate_lifted(TP(*ROUGH), s0, 0.5, _gen(1), n_steps=4, n_paths=101)
    eur, _ = tr.price_european_rough_mc(TP(*ROUGH), 100.0, 0.5, s0, replay, rate=0.05,
                                        is_call=False, **kw)
    amer, _ = tr.price_american_rough_lsm(TP(*ROUGH), 100.0, 0.5, s0, replay, rate=0.05, **kw)
    assert float(amer) > float(eur)
    deep, _ = tr.price_american_rough_lsm(TP(*ROUGH), 125.0, 0.5, s0, _gen(2), rate=0.05, **kw)
    assert float(deep) >= 25.0 - 1e-9
