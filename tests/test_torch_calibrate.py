"""The PyTorch port's calibration slice held against the JAX package.

* LM is deterministic: the same Heston residuals, start, bounds and
  iteration count in float64 give the same x and cost (1e-8 relative).
* DE draws differ by design (torch.Generator vs JAX threefry): a fixed
  generator seed gives a deterministic run, and both packages' full
  pipelines recover the truth on a small surface.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.calibrate import lm as jlm
from pde_tpu.calibrate.heston import HestonCalibrator as JaxCalibrator
from pde_tpu.calibrate.heston import _price_vec_gl_grouped as jax_price_gl
from pde_tpu.models import heston as jh
from pde_tpu_torch import interop
from pde_tpu_torch.calibrate import de as tde
from pde_tpu_torch.calibrate import lm as tlm
from pde_tpu_torch.calibrate.heston import CalibrationError, HestonCalibrator
from pde_tpu_torch.calibrate.heston import _price_vec_gl_grouped as torch_price_gl
from pde_tpu_torch.models.heston import HestonParams

S0, R, Q = 100.0, 0.05, 0.02
TRUE = dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04)
F64 = torch.float64
LOWER = np.array([0.1, 0.01, 0.01, -0.99, 0.01])
UPPER = np.array([10.0, 1.0, 2.0, 0.99, 1.0])


@pytest.fixture(scope="module")
def surface():
    """A noisy surface: the LM optimum keeps a cost well above round-off,
    so the cost comparison means something."""
    data = JaxCalibrator.generate_synthetic_data(S0=S0, r=R, q=Q, **TRUE,
                                                 n_strikes=9, n_maturities=3,
                                                 noise_std=0.01, seed=3)
    unique_T, t_idx = jh.group_maturities(data["maturity"])
    return data, unique_T, t_idx


def _residual_fns(surface):
    data, unique_T, t_idx = surface
    K, P, calls = data["strike"], data["mid_price"], data["is_call"]

    def jax_res(x):
        return jax_price_gl(x, K, t_idx, unique_T, calls, S0, R, Q) / P - 1.0

    tK, _, tP, tcalls = interop.quotes(K, data["maturity"], P, calls)
    tti, tuT = interop.grouping(t_idx, unique_T)

    def torch_res(x):
        return torch_price_gl(x, tK, tti, tuT, tcalls, S0, R, Q) / tP - 1.0

    return jax_res, torch_res


@pytest.mark.parametrize("starts", [
    [[1.5, 0.05, 0.4, -0.5, 0.05]],
    [[1.5, 0.05, 0.4, -0.5, 0.05], [4.0, 0.1, 0.8, -0.2, 0.02],
     [0.8, 0.03, 0.2, -0.9, 0.06]],
])
def test_lm_matches_reference(surface, starts):
    """max_iter=8 on the Heston residuals, one start or a batch of starts
    (the reference vmaps; the port takes the batch dimension)."""
    jax_res, torch_res = _residual_fns(surface)
    x0 = np.array(starts)
    want = jax.vmap(lambda s: jlm.levenberg_marquardt(
        jax_res, s, LOWER, UPPER, max_iter=8))(jnp.asarray(x0))
    got = tlm.levenberg_marquardt(torch_res, interop.tensor(x0), interop.tensor(LOWER),
                                  interop.tensor(UPPER), max_iter=8)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-8)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    single = tlm.levenberg_marquardt(torch_res, interop.tensor(x0[0]), interop.tensor(LOWER),
                                     interop.tensor(UPPER), max_iter=8)
    assert single.x.shape == (5,)
    np.testing.assert_allclose(single.x.numpy(), got.x[0].numpy(), rtol=1e-12)


def test_lm_respects_bounds_and_solves_linear():
    A = torch.tensor([[1.0, 2.0], [3.0, -1.0], [0.5, 0.5]], dtype=F64)
    b = A @ torch.tensor([0.7, -0.4], dtype=F64)
    res = tlm.levenberg_marquardt(lambda x: A @ x - b, torch.zeros(2, dtype=F64),
                                  torch.tensor([-5.0, -5.0], dtype=F64),
                                  torch.tensor([5.0, 5.0], dtype=F64), max_iter=30)
    np.testing.assert_allclose(res.x.numpy(), [0.7, -0.4], atol=1e-8)
    assert bool(res.converged)
    clipped = tlm.levenberg_marquardt(lambda x: A @ x - b, torch.zeros(2, dtype=F64),
                                      torch.tensor([1.0, -5.0], dtype=F64),
                                      torch.tensor([5.0, 5.0], dtype=F64), max_iter=30)
    assert float(clipped.x[0]) == 1.0


def _sphere(pop):
    return torch.sum((pop - torch.tensor([0.3, -0.7, 1.1], dtype=pop.dtype)) ** 2, dim=-1)


def _de(seed, **kw):
    gen = torch.Generator().manual_seed(seed)
    return tde.differential_evolution(_sphere, -2.0 * torch.ones(3, dtype=F64),
                                      2.0 * torch.ones(3, dtype=F64), gen, **kw)


def test_de_seeded_generator_is_deterministic():
    a, b, c = _de(7, maxiter=30), _de(7, maxiter=30), _de(8, maxiter=30)
    for f in ("x", "fun", "population", "population_energies"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(a.population, c.population)


@pytest.mark.parametrize("kw,stops_early", [
    (dict(maxiter=120), False),
    (dict(maxiter=120, target_energy=1e-3), True),
    (dict(maxiter=120, param_tol=1e-2), True),
    (dict(maxiter=120, stagnation_patience=3, stagnation_rtol=0.9), True),
])
def test_de_stop_rules(kw, stops_early):
    res = _de(4, **kw)
    assert (int(res.n_iter) < 120) == stops_early
    if not stops_early:
        np.testing.assert_allclose(res.x.numpy(), [0.3, -0.7, 1.1], atol=2e-2)
    if "target_energy" in kw:
        assert float(res.fun) <= 1e-3


def test_de_warm_start_seeds_population():
    x0 = torch.tensor([0.3, -0.7, 1.1], dtype=F64)
    res = _de(1, maxiter=1, x0=x0)
    assert float(res.fun) <= 1e-12


def _small_surface():
    return JaxCalibrator.generate_synthetic_data(S0=S0, r=R, q=Q, **TRUE,
                                                 n_strikes=4, n_maturities=3)


@pytest.fixture(scope="module")
def fits():
    """Both packages' full two-stage pipelines on a 4 x 3 surface, with the
    budget tests/test_calibrate.py shows to recover (DE 40 x 10, LM 60)."""
    data = _small_surface()
    budget = dict(global_maxiter=40, global_popsize=10, seed=42)
    jax_fit = JaxCalibrator(**budget).calibrate(data, S0=S0, r=R, q=Q)
    torch_fit = HestonCalibrator(dtype=F64, **budget).calibrate(data, S0=S0, r=R, q=Q)
    return data, jax_fit, torch_fit


@pytest.mark.parametrize("name", list(TRUE))
def test_pipeline_recovers_truth_in_both_packages(fits, name):
    _, jax_fit, torch_fit = fits
    p_t, p_j = getattr(torch_fit.params, name), getattr(jax_fit.params, name)
    assert abs(p_t - TRUE[name]) < 1e-4
    assert abs(p_t - p_j) < 1e-4


def test_pipeline_fit_quality(fits):
    data, jax_fit, torch_fit = fits
    for fit in (jax_fit, torch_fit):
        assert fit.fit_quality["relative_rmse"] < 1e-6
        assert fit.success
    assert torch_fit.fit_quality["n_options"] == len(data["strike"])
    assert 0 < torch_fit.convergence["global_nit"] <= 40


def test_padded_quote_slots_leave_the_fit_unchanged(fits):
    """pad_shapes pads quotes to 32 and maturities to a bucket of 2: the
    masked slots must not move the result."""
    data, _, padded = fits
    plain = HestonCalibrator(dtype=F64, global_maxiter=40, global_popsize=10,
                             seed=42, pad_shapes=False).calibrate(data, S0=S0, r=R, q=Q)
    for name in TRUE:
        assert getattr(plain.params, name) == pytest.approx(
            getattr(padded.params, name), abs=1e-9)
    assert plain.convergence["global_nit"] == padded.convergence["global_nit"]


def test_synthetic_data_matches_reference():
    want = _small_surface()
    got = HestonCalibrator.generate_synthetic_data(S0=S0, r=R, q=Q, **TRUE, n_strikes=4,
                                                   n_maturities=3, dtype=F64)
    np.testing.assert_array_equal(got["strike"], want["strike"])
    np.testing.assert_allclose(got["mid_price"], want["mid_price"], rtol=0, atol=1e-8)


def test_validation_and_warnings_match_reference():
    with pytest.raises((ValueError, CalibrationError)):
        HestonCalibrator().calibrate(
            {"strike": [100.0], "maturity": [1.0], "mid_price": [-5.0]},
            S0=100.0, r=0.05, q=0.0)
    for p in ((1.345, 0.192, 1.601, 0.286, 0.724), (2.0, 0.04, 0.3, -0.7, 0.04),
              (9.0, 0.01, 1.8, -0.97, 0.6)):
        assert (HestonCalibrator._validate_parameters(HestonParams(*p), max_maturity=2.0)
                == JaxCalibrator._validate_parameters(jh.HestonParams(*p), max_maturity=2.0))


class _FakeDB:
    def __init__(self):
        self.stored = []

    def store_model_parameters(self, **kw):
        self.stored.append(kw)

    def get_latest_model_parameters(self, **kw):
        if not self.stored:
            return None
        last = self.stored[-1]
        return {"parameters": last["parameters"], "fit_quality": last["fit_quality"],
                "converged": last["converged"], "time": "t0"}


def test_db_hooks_store_and_fall_back_to_cache(fits):
    data, _, _ = fits
    db = _FakeDB()
    cal = HestonCalibrator(db=db, dtype=F64, global_maxiter=3, global_popsize=4,
                           local_max_iter=3)
    cal.calibrate(data, S0=S0, r=R, q=Q, warm_start=TRUE, underlying="SPX")
    assert db.stored[0]["underlying"] == "SPX"
    assert db.stored[0]["model_type"] == "heston"
    db.stored[0]["converged"] = True
    # an incomplete warm start fails inside the calibration: the cached
    # parameters come back instead
    cached = cal.calibrate(data, S0=S0, r=R, q=Q, underlying="SPX",
                           warm_start={"kappa": 2.0})
    assert cached.convergence == {"cached": True}
    assert cached.params.v0 == db.stored[0]["parameters"]["v0"]
    with pytest.raises(CalibrationError):
        cal.calibrate(data, S0=S0, r=R, q=Q, warm_start={"kappa": 2.0},
                      use_cached_on_failure=False)
