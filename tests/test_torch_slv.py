"""Stochastic-local volatility (``pde_tpu_torch/models/slv.py``) held
against ``pde_tpu`` (x64) on the CPU.

The port runs on the reference's own draws (``jax_key_draws.JaxKey``:
``n_steps`` step keys, then ``(u, z)`` a step).  Gates, each with its
reason:
- the binned E[v | S] (counts, sums, the ``min_count`` rule, bin indices)
  with particles placed exactly on bin edges: indices equal (``searchsorted``
  on the left, as ``jnp.searchsorted``), means at 1e-12 relative (the
  one-hot product sums each bin in another order than ``segment_sum``);
- the interpolation of the leverage to the particles against
  ``jnp.interp``, knots and both flat ends included: 1e-14;
- ``calibrate_leverage`` (surface and cloud), ``simulate_slv`` on the
  reference's calibrated surface (``interop.leverage_surface``) and the
  Heston estimators through ``slv_simulate_fn``: 1e-10 relative in float64
  (the same arithmetic on the same draws);
- the reference suite's checks on the port's generator (Philox): a unit
  leverage reproduces the QE engine on the same draws (2e-5, the
  reference's gate: the coefficients are split by leverage power and
  regrouped), the discounted spot a martingale under a skewed leverage
  (4 s.e.), and a self-targeted calibration (the model's own Dupire
  surface) gives L within 0.1 of 1 in the central bins at mid sweep.
Sizes: at most 4096 particles x 16 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey

from pde_tpu.models import heston_mc as jmc
from pde_tpu.models import slv as jslv
from pde_tpu.models.heston import HestonParams as JParams
from pde_tpu_torch import interop
from pde_tpu_torch.models import heston_mc as tmc
from pde_tpu_torch.models import local_vol as tlv
from pde_tpu_torch.models import slv as tslv
from pde_tpu_torch.models.heston import HestonParams as TParams

F64 = torch.float64
CPU = torch.device("cpu")
FIELDS = (2.0, 0.04, 0.4, -0.6, 0.05)
JP, TP = JParams(*FIELDS), TParams(*FIELDS)
S0, R, Q, T = 100.0, 0.04, 0.01, 0.75
KEY = jax.random.PRNGKey(11)
KW = dict(n_paths=2048, rate=R, dividend=Q)
REL = dict(rtol=1e-10, atol=0.0)


def _close(got, want, **gate):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want),
                               **(gate or REL))


def _j_target(s, t):
    return 0.22 + 0.08 * jnp.tanh(jnp.log(100.0 / s)) + 0.02 * t


def _t_target(s, t):
    return 0.22 + 0.08 * torch.tanh(torch.log(100.0 / s)) + 0.02 * t


def test_bin_expectation_matches_reference_with_particles_on_edges(tmp_path):
    rng = np.random.default_rng(0)
    edges = np.linspace(4.2, 5.0, 12)
    ln_s = np.concatenate([rng.normal(4.6, 0.15, 500), edges, [3.0, 6.0]])
    v = rng.uniform(0.01, 0.09, ln_s.shape[0])
    for min_count in (1, 8, 40):
        want_ev, want_idx = jslv._bin_expectation(jnp.asarray(ln_s), jnp.asarray(v),
                                                  jnp.asarray(edges), 11, min_count=min_count)
        ev, idx = tslv._bin_expectation(torch.tensor(ln_s), torch.tensor(v), torch.tensor(edges),
                                        11, min_count=min_count)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        _close(ev, want_ev, rtol=1e-12, atol=0.0)
    # a particle exactly on an inner edge falls in the bin below it
    on_edge = tslv._bin_expectation(torch.tensor(edges[3:4]), torch.tensor([0.04]),
                                    torch.tensor(edges), 11, min_count=1)[1]
    assert int(on_edge[0]) == 2
    # with axis_name, the particles split over P = 2 and 4 gloo ranks: the
    # all-reduced bin sums give the reference's single-cloud E[v | S] at
    # 1e-12 (tests/test_mc_sharded.py:133-157) and the same bins, on every
    # rank (the cloud cut to a multiple of 4: 512 of its 514 particles)
    import torch_dist_workers as W

    cut = (ln_s[:512], v[:512])
    args = (torch.tensor(cut[0]), torch.tensor(cut[1]), torch.tensor(edges), 11)
    run = W.run_ranks(4, [(f"p{P}_{m}", W.case_bin_expectation, (P, *args, m))
                          for P in (2, 4) for m in (1, 8, 40)], tmp_path)
    for P in (2, 4):
        for min_count in (1, 8, 40):
            want_ev, want_idx = jslv._bin_expectation(*(jnp.asarray(a) for a in cut),
                                                      jnp.asarray(edges), 11,
                                                      min_count=min_count)
            got = W.same_on_every_rank(W.outputs(run, f"p{P}_{min_count}"))
            np.testing.assert_array_equal(got["idx"], np.asarray(want_idx))
            np.testing.assert_allclose(got["ev"], np.asarray(want_ev), rtol=1e-12, atol=0.0)


def test_interp_is_jnp_interp():
    xp = np.linspace(4.0, 5.2, 9)
    fp = np.cos(3.0 * xp) + 1.5
    x = np.concatenate([np.linspace(3.5, 5.6, 101), xp])
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = tslv._interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15)


@pytest.fixture(scope="module")
def calibrated():
    kw = dict(n_steps=12, n_bins=15, **KW)
    want = jslv.calibrate_leverage(JP, _j_target, S0, T, KEY, **kw)
    got = tslv.calibrate_leverage(TP, _t_target, torch.tensor(S0, dtype=F64), T, JaxKey(KEY),
                                  **kw)
    return want, got


def test_calibrate_leverage_matches_reference(calibrated):
    (want_lev, want_paths), (lev, paths) = calibrated
    assert lev.values.shape == (12, 15) and lev.values.dtype == F64
    for g, w in zip(lev, want_lev):
        _close(g, w)
    for g, w in zip(paths[:5], want_paths[:5]):
        _close(g, w)


@pytest.mark.parametrize("antithetic", [True, False])
def test_simulate_slv_on_the_reference_surface(calibrated, antithetic):
    want_lev = calibrated[0][0]
    key = jax.random.PRNGKey(12)
    want = jslv.simulate_slv(JP, want_lev, S0, T, key, antithetic=antithetic, **KW)
    got = tslv.simulate_slv(TP, interop.leverage_surface(want_lev), torch.tensor(S0, dtype=F64),
                            T, JaxKey(key), antithetic=antithetic, **KW)
    for g, w in zip(got[:5], want[:5]):
        _close(g, w)
    with pytest.raises(ValueError, match="calibrated rows"):
        tslv.simulate_slv(TP, interop.leverage_surface(want_lev), S0, T, JaxKey(key),
                          n_steps=7, device=CPU)


ESTIMATORS = {
    "european": lambda m, fn, k, s: m.price_european_mc(
        m_params(m), np.array([90.0, 100.0, 110.0]), T, s, k, simulate_fn=fn, **KW),
    "barrier_down_and_out": lambda m, fn, k, s: m.price_barrier_mc(
        m_params(m), 100.0, 80.0, T, s, k, barrier_type="down-and-out", simulate_fn=fn, **KW),
}


def m_params(m):
    return JP if m is jmc else TP


@pytest.mark.parametrize("case", sorted(ESTIMATORS))
def test_estimators_through_slv_simulate_fn(calibrated, case):
    want_lev = calibrated[0][0]
    key = jax.random.PRNGKey(13)
    want = ESTIMATORS[case](jmc, jslv.slv_simulate_fn(want_lev), key, S0)
    got = ESTIMATORS[case](tmc, tslv.slv_simulate_fn(interop.leverage_surface(want_lev)),
                           JaxKey(key), torch.tensor(S0, dtype=F64))
    for g, w in zip(got, want):
        _close(g, w)


def _replay(seed):
    return tmc._Replay(tmc._draws(torch.Generator().manual_seed(seed), CPU))


def test_unit_leverage_is_the_qe_engine():
    n_steps = 16
    ones = tslv.LeverageSurface(torch.linspace(3.5, 5.5, 11, dtype=F64),
                                torch.linspace(0.0, T, n_steps + 1, dtype=F64)[:-1],
                                torch.ones((n_steps, 11), dtype=F64))
    replay = _replay(7)
    s0 = torch.tensor(S0, dtype=F64)
    a = tslv.simulate_slv(TP, ones, s0, T, replay, n_paths=4096, rate=R, dividend=Q)
    b = tmc.simulate_qe(TP, s0, T, replay, n_steps=n_steps, n_paths=4096, rate=R, dividend=Q)
    np.testing.assert_allclose(a.spot.numpy(), b.spot.numpy(), rtol=2e-5)
    np.testing.assert_allclose(a.variance.numpy(), b.variance.numpy(), rtol=2e-5, atol=1e-10)


def test_martingale_under_a_skewed_leverage():
    n_steps = 16
    centers = torch.linspace(float(np.log(50.0)), float(np.log(200.0)), 15, dtype=F64)
    row = 0.6 + 1.2 * (centers.flip(0) - centers[0]) / (centers[-1] - centers[0])
    lev = tslv.LeverageSurface(centers, torch.linspace(0.0, T, n_steps + 1, dtype=F64)[:-1],
                               row[None, :].expand(n_steps, 15))
    paths = tslv.simulate_slv(TP, lev, torch.tensor(S0, dtype=F64), T,
                              torch.Generator().manual_seed(3), n_paths=4096, rate=0.06,
                              dividend=0.02)
    disc = paths.spot * np.exp(-0.06 * T)
    mean, se = tmc._mc_estimate(disc, 4096, True)
    assert abs(float(mean) - S0 * np.exp(-0.02 * T)) < 4.0 * float(se)


def test_self_target_gives_unit_leverage():
    """The model's own Dupire surface as the target: L ~ 1 where the cloud
    carries mass (tests/test_slv.py::TestParticleCalibration, smaller)."""
    ks = np.exp(np.linspace(np.log(55.0), np.log(180.0), 16))
    ts = np.concatenate([[0.01, 0.03, 0.08], np.linspace(0.15, T + 0.2, 4)])
    surf = tlv.dupire_surface(TP, torch.tensor(ks), torch.tensor(ts), S0, R, Q, device=CPU,
                              dtype=F64)
    interp = tlv.SurfaceInterpolator(torch.tensor(ks), torch.tensor(ts), surf)
    lev, _ = tslv.calibrate_leverage(TP, interp, torch.tensor(S0, dtype=F64), T,
                                     torch.Generator().manual_seed(11), n_steps=16,
                                     n_paths=4096, n_bins=15, rate=R, dividend=Q)
    central = lev.values[8, 5:10]
    assert bool(((central - 1.0).abs() < 0.1).all()), central
