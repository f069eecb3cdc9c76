"""Batched surface calibration (``HestonCalibrator.calibrate_batch``), the
surface axis of ``differential_evolution`` and ``parameter_sensitivities``.

The surfaces are priced by the JAX package (as tests/test_parallel.py:415-450
prices them) and calibrated by the port in float64 on the CPU.  The DE
draws of the two packages differ draw for draw (torch.Generator against
JAX's split keys), so the fits are held to the JAX test's own gates on
the converged parameters and costs; the sensitivities are deterministic
and held against the JAX package at 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.calibrate.heston import parameter_sensitivities as jax_sensitivities
from pde_tpu.models import heston as jh
from pde_tpu_torch.calibrate import de as tde
from pde_tpu_torch.calibrate import heston as tcal
from pde_tpu_torch.calibrate.heston import HestonCalibrator, parameter_sensitivities
from pde_tpu_torch.models.heston import HestonParams

S0, R, Q = 100.0, 0.05, 0.02
TRUTH = [2.0, 0.04, 0.3, -0.7, 0.04]
F64 = torch.float64
U, NQ = 2, 16
SMALL = dict(global_maxiter=8, global_popsize=4, local_max_iter=6)
JAX_TEST_BUDGET = dict(global_maxiter=30, global_popsize=8, local_max_iter=20)


@pytest.fixture(scope="module")
def book():
    """U copies of a 16-quote, two-maturity surface (test_parallel.py's)."""
    strikes = np.tile(np.linspace(90.0, 110.0, NQ), (U, 1))
    maturities = np.tile(np.repeat([0.5, 1.0], NQ // 2), (U, 1))
    prices = np.maximum(np.asarray(jax.jit(jh.price_options)(
        jh.HestonParams(*TRUTH), jnp.asarray(strikes.ravel()),
        jnp.asarray(maturities.ravel()), S0, R, Q)).reshape(U, NQ), 0.01)
    return strikes, maturities, prices, np.full(U, S0)


def _calibrate(book, **budget):
    cal = HestonCalibrator(device="cpu", dtype=F64, **budget)
    return cal.calibrate_batch(*book, R, Q)


def test_shapes_and_finite_costs(book):
    out = _calibrate(book, **SMALL)
    assert tuple(out["params"].shape) == (U, 5)
    assert tuple(out["model_prices"].shape) == (U, NQ)
    for k in ("cost", "converged", "de_n_iter", "lm_n_iter"):
        assert tuple(out[k].shape) == (U,), k
    for k, v in out.items():
        assert v.device.type == "cpu", k
    assert out["params"].dtype == F64 and out["converged"].dtype == torch.bool
    assert bool(torch.isfinite(out["cost"]).all())
    assert bool(torch.isfinite(out["model_prices"]).all())
    assert int(out["de_n_iter"].max()) <= SMALL["global_maxiter"]


def test_recovers_truth_at_the_jax_tests_budget(book):
    """tests/test_parallel.py's gates: cost < 1e-3 (< 1% rms relative
    error), and the identifiable v0 and theta within 0.01 of the truth."""
    out = _calibrate(book, **JAX_TEST_BUDGET)
    params = out["params"].numpy()
    assert np.all(out["cost"].numpy() < 1e-3)
    np.testing.assert_allclose(params[:, 4], TRUTH[4], atol=0.01)
    np.testing.assert_allclose(params[:, 1], TRUTH[1], atol=0.01)
    # each surface's reported prices are its own fit's on the reference grid
    one = tcal._price_vec_grouped(out["params"][0], torch.as_tensor(book[0][0]),
                                  torch.as_tensor(np.repeat([0, 1], NQ // 2)),
                                  torch.tensor([0.5, 1.0], dtype=F64), True, S0, R, Q)
    np.testing.assert_allclose(out["model_prices"][0].numpy(), one.numpy(), rtol=0,
                               atol=1e-12)


def test_one_objective_call_a_generation_and_one_lm_call_a_pass(book, monkeypatch):
    """Every DE generation prices all U surfaces' populations in one call,
    and each LM pass polishes all U x k starts in one call."""
    pops, starts = [], []
    objective, lm = tcal._objective_population_gl_grouped, tcal.levenberg_marquardt

    def counted_objective(pop, *args, **kw):
        pops.append(tuple(pop.shape))
        return objective(pop, *args, **kw)

    def counted_lm(fn, x0, *args, **kw):
        starts.append(tuple(x0.shape))
        return lm(fn, x0, *args, **kw)

    monkeypatch.setattr(tcal, "_objective_population_gl_grouped", counted_objective)
    monkeypatch.setattr(tcal, "levenberg_marquardt", counted_lm)
    out = _calibrate(book, **SMALL)
    npop = SMALL["global_popsize"] * 5
    assert pops == [(U, npop, 5)] * (1 + int(out["de_n_iter"].max()))
    k = min(4, npop) + 1  # top-k DE members and one informed start
    assert starts == [(U * k, 5)] * 2


def test_ragged_maturity_counts_pad_to_a_common_m(book):
    """The surface with fewer unique maturities (2 against 3) is padded
    with its last one; both fit to the gates."""
    strikes, maturities, prices, spots = book
    maturities = maturities.copy()
    maturities[1] = np.repeat([0.25, 0.75, 1.25], [6, 5, 5])
    prices = prices.copy()
    prices[1] = np.asarray(jh.price_options(jh.HestonParams(*TRUTH), strikes[1],
                                            maturities[1], S0, R, Q))
    out = _calibrate((strikes, maturities, prices, spots), **JAX_TEST_BUDGET)
    assert np.all(out["cost"].numpy() < 1e-3)
    np.testing.assert_allclose(out["params"].numpy()[:, 4], TRUTH[4], atol=0.01)


def test_mesh_is_not_ported(book):
    with pytest.raises(NotImplementedError, match="A.7"):
        HestonCalibrator(device="cpu", dtype=F64, **SMALL).calibrate_batch(
            *book, R, Q, mesh=object())


# ------------------------------------------------------ DE with a surface axis

def _sphere(pop):
    return torch.sum((pop - torch.tensor([0.3, -0.7, 1.1], dtype=pop.dtype)) ** 2, dim=-1)


BOX = (-2.0 * torch.ones(3, dtype=F64), 2.0 * torch.ones(3, dtype=F64))


@pytest.mark.parametrize("kw", [
    dict(maxiter=30),
    dict(maxiter=120, target_energy=1e-3),
    dict(maxiter=120, param_tol=1e-2),
    dict(maxiter=120, stagnation_patience=3, stagnation_rtol=0.9),
    dict(maxiter=5, x0=torch.tensor([0.3, -0.7, 1.1], dtype=F64)),
])
def test_one_surface_axis_is_the_single_call_bit_for_bit(kw):
    single = tde.differential_evolution(_sphere, *BOX, torch.Generator().manual_seed(4), **kw)
    batched = tde.differential_evolution(lambda pop: _sphere(pop[0])[None], *BOX,
                                         torch.Generator().manual_seed(4), n_surfaces=1,
                                         **kw)
    for name, a, b in zip(single._fields, single, batched):
        assert tuple(b.shape) == (1,) + tuple(a.shape), name
        assert torch.equal(a, b[0]), name


def _two_surfaces(maxiter):
    """Surface 0 reaches its target energy after a few generations; surface 1
    has none and runs to maxiter."""
    centres = torch.tensor([[0.3, -0.7, 1.1], [-1.0, 0.5, 0.2]], dtype=F64)
    calls = []

    def objective(pop):
        calls.append(tuple(pop.shape))
        return torch.sum((pop - centres[:, None, :]) ** 2, dim=-1)

    res = tde.differential_evolution(objective, *BOX, torch.Generator().manual_seed(9),
                                     popsize=6, maxiter=maxiter, n_surfaces=2,
                                     target_energy=torch.tensor([1e-4, 0.0], dtype=F64))
    return res, calls


def test_a_stopped_surface_keeps_its_population():
    long, calls = _two_surfaces(40)
    g0 = int(long.n_iter[0])
    assert 0 < g0 < 40 and int(long.n_iter[1]) == 40
    assert calls == [(2, 18, 3)] * 41
    assert float(long.fun[0]) <= 1e-4
    # the population surface 0 had when it stopped is the one it keeps while
    # surface 1 goes on (the draws of the first g0 generations are the same
    # whatever maxiter is)
    for maxiter in (g0, 20):
        short, _ = _two_surfaces(maxiter)
        assert torch.equal(short.population[0], long.population[0])
        assert torch.equal(short.population_energies[0], long.population_energies[0])
    assert not torch.equal(short.population[1], long.population[1])


# -------------------------------------------------- quote-level sensitivities

@pytest.fixture(scope="module")
def sensitivities():
    K, T = np.meshgrid(np.linspace(85.0, 115.0, 8), np.array([0.25, 0.75, 1.5]))
    K, T = K.ravel(), T.ravel()
    calls = K >= S0
    prices = np.asarray(jh.price_carr_madan_gl_grouped(
        jh.HestonParams(*TRUTH), K, *reversed(jh.group_maturities(T)), S0, R, Q, calls))
    want = jax_sensitivities(jh.HestonParams(*TRUTH), K, T, calls, prices, S0, R, Q,
                             quote_noise_rel=0.01)
    got = parameter_sensitivities(HestonParams(*TRUTH), K, T, calls, prices, S0, R, Q,
                                  quote_noise_rel=0.01, device="cpu", dtype=F64)
    return want, got


@pytest.mark.parametrize("key", ["dparams_dprice", "influence", "param_std", "param_cov",
                                 "model_prices"])
def test_parameter_sensitivities_match_reference(sensitivities, key):
    want, got = sensitivities
    assert sorted(got) == sorted(want)
    assert isinstance(got[key], np.ndarray) and got[key].shape == np.shape(want[key])
    scale = np.max(np.abs(want[key]))
    np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-12 * scale)


def test_parameter_sensitivities_without_noise_omit_the_covariance():
    K, T = np.linspace(90.0, 110.0, 6), np.repeat([0.5, 1.0], 3)
    prices = np.asarray(jh.price_carr_madan_gl(jh.HestonParams(*TRUTH), K, T, S0, R, Q))
    got = parameter_sensitivities(HestonParams(*TRUTH), K, T, np.ones(6, bool), prices,
                                  S0, R, Q, device="cpu", dtype=F64)
    assert sorted(got) == ["dparams_dprice", "influence", "model_prices"]
    assert got["dparams_dprice"].shape == (5, 6)
