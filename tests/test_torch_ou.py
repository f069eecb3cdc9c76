"""The port's OU model and fitter held against ``pde_tpu``.

The same numpy inputs go through both packages in float64 (the JAX side
under ``jax_enable_x64``).  Gates, each with its reason:
- every function of ``models/ou.py``: 1e-12 relative, the same arithmetic
  in the same order (the sums of the moments may differ in order: ~1e-15);
- the path functions run on JAX's own draws (threefry and torch's Philox
  streams differ): ``jax.random.normal(key, (n,))`` as numpy fed to both;
- ``simulate_parallel`` against ``simulate`` on one generator's draws:
  1e-10, the same recurrence reassociated into a log-depth scan;
- ``OUFitter.fit`` (analytical and the L-BFGS-B refinement): parameters
  and boundaries at 1e-8, scipy's iterates on gradients that agree to
  roundoff.
The reference's golden C++ path (tests/golden/reference_values.json) is one
of the series.

The port's float32 fits are held against the reference's float64 fits.
Both fits take their moments of each series less its first value, which
float32 needs on a series far from zero: raw moments cancel, and put a
float32 mu off by up to 280% on OU paths about 100 and by up to 25% on
log closes.  Gates, every path of the smoke's 1024 OU(100, 5, 2) paths of
252 steps: theta 1e-5, mu 1e-3, sigma 1e-4 relative (the CPU reads 1.0e-6,
4.5e-5, 1.6e-5 for ``fit_mle``, 1.5e-6, 5.7e-5, 4.8e-6 for ``fit_batch``);
``OUFitter.fit`` on the simulated provider's log closes: mu 1e-3 relative
(the CPU reads 1.7e-5 at most).
"""

import datetime
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.calibrate import ou as jcal
from pde_tpu.models import ou as jou
from pde_tpu_torch import interop
from pde_tpu_torch.calibrate import ou as tcal
from pde_tpu_torch.data.providers import SimulatedDataProvider
from pde_tpu_torch.models import ou as tou

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "reference_values.json").read_text())
REL = dict(rtol=1e-12, atol=0.0)
DT = 1.0 / 252.0
JP = jou.OUParams(theta=100.0, mu=5.0, sigma=2.0)
TP = interop.ou_params(JP)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, **gate):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(gate or REL))


def _spreads(rng, B=4, n=300, theta=0.0, mu=5.0, sigma=0.2):
    """B seeded OU spreads (numpy exact discretisation), shape (B, n + 1)."""
    a = np.exp(-mu * DT)
    s = np.sqrt(sigma**2 * (1 - np.exp(-2 * mu * DT)) / (2 * mu))
    x = np.empty((B, n + 1))
    x[:, 0] = theta + rng.normal(0.0, 0.05, B)
    for i in range(n):
        x[:, i + 1] = theta + (x[:, i] - theta) * a + s * rng.normal(size=B)
    return x


MODEL_CASES = {
    "conditional_mean": (lambda m, p: m.conditional_mean(103.0, p, DT)),
    "conditional_variance": (lambda m, p: m.conditional_variance(p, DT)),
    "transition_density": (lambda m, p: m.transition_density(100.5, 103.0, p, DT)),
    "transition_density_degenerate": (lambda m, p: m.transition_density(
        100.0, 100.0, p._replace(sigma=0.0 * p.sigma), DT)),
    "conditional_variance_brownian": (lambda m, p: m.conditional_variance(
        p._replace(mu=0.0 * p.mu), DT)),
    "half_life": (lambda m, p: p.half_life()),
    "stationary_variance": (lambda m, p: p.stationary_variance()),
    "stationary_std": (lambda m, p: p.stationary_std()),
    "half_life_no_reversion": (lambda m, p: p._replace(mu=-1.0 + 0.0 * p.mu).half_life()),
    "optimal_boundaries": (lambda m, p: m.optimal_boundaries(p, 0.001, 0.05)),
}


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_functions_match_reference(name):
    want = MODEL_CASES[name](jou, jou.OUParams(*(jnp.asarray(v) for v in JP)))
    got = MODEL_CASES[name](tou, TP)
    for g, w in zip(np.atleast_1d(np.array(got, dtype=object)),
                    np.atleast_1d(np.array(want, dtype=object))):
        _close(float(g), float(w))


def test_golden_path_moments():
    """The reference's golden values hold for the port as they hold for
    ``pde_tpu`` (tests/test_ou.py:29-60)."""
    path = _t(GOLDEN["ou_path"])
    res = tou.fit_mle(path, DT)
    assert abs(float(res.params.theta) - GOLDEN["ou_fit_theta"]) < 1e-8
    assert abs(float(res.params.mu) - GOLDEN["ou_fit_mu"]) < 1e-6
    assert abs(float(res.params.sigma) - GOLDEN["ou_fit_sigma"]) < 1e-8
    assert abs(float(res.log_likelihood) - GOLDEN["ou_fit_ll"]) < 1e-6
    assert abs(float(tou.log_likelihood(path, TP, DT)) - GOLDEN["ou_ll_true_params"]) < 1e-6
    assert abs(float(tou.conditional_mean(103.0, TP, DT)) - GOLDEN["ou_cond_mean"]) < 1e-12


@pytest.mark.parametrize("series", ["golden", "spreads", "constant", "anti", "brownian"])
def test_fit_mle_and_log_likelihood_match_reference(rng, series):
    """fit_mle over the last axis against the reference vmapped over
    series: the golden C++ path, a batch of spreads about 0, a constant
    series (degenerate), an alternating one (slope clamped at 1e-4) and a
    random walk (slope clamped at 0.9999 or near it)."""
    x = {"golden": lambda: np.array(GOLDEN["ou_path"]),
         "spreads": lambda: _spreads(rng),
         "constant": lambda: np.full(50, 7.0),
         "anti": lambda: np.tile([1.0, -1.0], 40) + rng.normal(0, 0.01, 80),
         "brownian": lambda: np.cumsum(rng.normal(0, 0.1, (3, 200)), -1)}[series]()
    want = jax.vmap(lambda s: jou.fit_mle(s, DT))(jnp.atleast_2d(jnp.asarray(x)))
    got = tou.fit_mle(_t(np.atleast_2d(x)), DT)
    # the moments subtract mean(x)^2 from mean(x^2): a series about a level
    # far from 0 (the golden path, about 100) loses log10(kappa) digits
    # there, so its fit depends on the order of the sums, which XLA and
    # torch choose differently; the gate scales by that condition number
    # (1 for the spreads about 0)
    kappa = max(1.0, float(np.max(np.mean(x, -1) ** 2 / np.maximum(np.var(x, -1), 1e-300))))
    gate = dict(rtol=1e-12 * (kappa if series == "golden" else 1.0), atol=0.0)
    # a constant series is degenerate in both; its slope flag is the sign of
    # a roundoff residue (XLA's mean of 49 sevens is 1 ulp below 7, torch's
    # is 7), so it is not compared
    flags = ("converged",) if series == "constant" else ("converged", "b_clamped")
    for f in ("log_likelihood", "aic", "bic") + flags:
        _close(getattr(got, f), getattr(want, f), **gate)
    for f in ("theta", "mu", "sigma"):
        _close(getattr(got.params, f), getattr(want.params, f), **gate)
    if series != "constant":
        ll_want = jax.vmap(lambda s: jou.log_likelihood(s, JP, DT))(
            jnp.atleast_2d(jnp.asarray(x)))
        _close(tou.log_likelihood(_t(np.atleast_2d(x)), TP, DT), ll_want)
    if series == "anti":
        assert bool(got.b_clamped.all())


@pytest.mark.parametrize("parallel", [False, True])
def test_path_functions_on_jax_draws(parallel):
    """simulate / simulate_parallel's path function on the very normals the
    reference draws from its key: 1e-12 relative."""
    key, n, x0, T = jax.random.PRNGKey(3), 512, 95.0, 1.0
    z = np.asarray(jax.random.normal(key, (n,), dtype=jnp.float64))
    jfn = jou.simulate_parallel if parallel else jou.simulate
    want = jfn(JP, x0, T, n, key)
    path = tou._path_parallel if parallel else tou._path
    got = path(TP, _t(x0), T / n, _t(z))
    assert got.shape == (n + 1,) and float(got[0]) == x0
    _close(got, want)


def test_simulate_parallel_matches_simulate():
    """Same generator seed, same normals: the log-depth scan reproduces the
    step loop to 1e-10, for one path and a fan of paths."""
    for shape in ((), (3,)):
        a, b = (fn(TP, _t(95.0), 1.0, 700, torch.Generator().manual_seed(5), shape=shape)
                for fn in (tou.simulate, tou.simulate_parallel))
        assert a.shape == shape + (701,) and a.dtype == torch.float64
        assert bool((a[..., 0] == 95.0).all())
        _close(b, a, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("fn", [tou.simulate, tou.simulate_parallel],
                         ids=["simulate", "simulate_parallel"])
def test_simulate_runs_on_the_inputs_device(fn):
    """A path runs on its inputs' device (``device=`` for plain numbers),
    and the generator must live there: a CPU generator for a path on the
    card raises rather than move the path to the CPU."""
    plain = tou.OUParams(100.0, 5.0, 2.0)
    for params, x0, kw in ((TP, _t(100.0), {}), (plain, 100.0, dict(device="cpu"))):
        path = fn(params, x0, 1.0, 8, torch.Generator().manual_seed(1), **kw)
        assert path.device == torch.device("cpu") and path.shape == (9,)
    with pytest.raises(ValueError, match="generator is on cpu"):
        fn(plain, 100.0, 1.0, 8, torch.Generator(), device="cuda")


def test_simulate_statistics():
    """A fan of paths from the generator: the stationary mean and std (the
    streams are not the reference's, the distribution is)."""
    paths = tou.simulate(TP, _t(100.0), 8.0, 2016, torch.Generator().manual_seed(11),
                         shape=(64,))
    tail = paths[:, 252:]
    assert abs(float(tail.mean()) - 100.0) < 0.1
    assert abs(float(tail.std()) - float(TP.stationary_std())) / float(TP.stationary_std()) < 0.1


@pytest.mark.parametrize("side", ["long", "short"])
def test_trading_signals_match_reference(side):
    lo, hi, ex = (float(v) for v in jou.optimal_boundaries(JP, 0.001))
    prices = ([100.0, lo - 0.5, lo - 0.2, 99.5, ex + 0.1, 100.0] if side == "long"
              else [hi + 0.5, hi + 0.1, ex - 0.1, hi + 1.0, ex])
    want = jou.generate_trading_signals(jnp.asarray(prices), JP, 0.001)
    got = tou.generate_trading_signals(_t(prices), TP, 0.001)
    np.testing.assert_array_equal(got["signals"].numpy(), np.asarray(want["signals"]))
    for k in ("entry_lower", "entry_upper", "exit_target"):
        _close(got[k], want[k])


def _fitter_series(rng, kind):
    if kind == "spread":
        return _spreads(rng, B=1, n=500)[0]
    if kind == "golden":
        return np.array(GOLDEN["ou_path"])
    return rng.normal(0, 0.02, 400)   # white noise: the slope clips at 0.001, mu > 50


@pytest.mark.parametrize("kind,method", [("spread", "analytical"), ("golden", "analytical"),
                                         ("spread", "numerical"), ("golden", "numerical"),
                                         ("noise", "analytical")])
def test_fitter_matches_reference(rng, kind, method):
    """OUFitter.fit: parameters, likelihood and boundaries at 1e-8; white
    noise's analytical mu leaves [0.01, 50] and takes the numerical branch
    in both packages."""
    X = _fitter_series(rng, kind)
    want = jcal.OUFitter().fit(X, method=method, pair_name="p")
    fitter = tcal.OUFitter(device="cpu", dtype=torch.float64)
    got = fitter.fit(X, method=method, pair_name="p")
    assert got.success == want.success and got.message == want.message
    for f in ("theta", "mu", "sigma"):
        _close(float(getattr(got.params, f)), float(getattr(want.params, f)),
               rtol=1e-8, atol=1e-10)
    for f in ("log_likelihood", "aic", "bic"):
        _close(getattr(got, f), getattr(want, f), rtol=1e-8)
    if want.boundaries is None:
        assert got.boundaries is None
    else:
        for k, v in want.boundaries.to_dict().items():
            _close(got.boundaries.to_dict()[k], v, rtol=1e-8, atol=1e-10)
        for k, v in want.residual_stats.items():
            _close(got.residual_stats[k], v, rtol=1e-6, atol=1e-10)
    assert got.n_observations == want.n_observations == len(X)
    assert set(got.to_dict()) == set(want.to_dict())
    assert "p" in fitter._cached_params


def test_fitter_batch_and_host_checks(rng):
    """fit_batch's analytical MLE over a (B, n) batch; the ADF check and
    the boundaries of given parameters (host arithmetic in both)."""
    X = _spreads(rng, B=3, n=250)
    fitter = tcal.OUFitter(device="cpu", dtype=torch.float64)
    want, got = jcal.OUFitter().fit_batch(X), fitter.fit_batch(X)
    for f in ("theta", "mu", "sigma"):
        _close(getattr(got, f), getattr(want, f))
    _close(np.stack(tcal._analytical_mle(_t(X[0]), DT)),
           np.stack(jcal._analytical_mle(jnp.asarray(X[0]), DT)))
    assert fitter.test_stationarity(X[0]) == jcal.OUFitter().test_stationarity(X[0])
    want_b = jcal.OUFitter().compute_optimal_boundaries(JP, 0.002).to_dict()
    got_b = fitter.compute_optimal_boundaries(TP, 0.002).to_dict()
    for k, v in want_b.items():
        _close(got_b[k], v)


def test_fitter_failure_and_synthetic_data(rng):
    """A constant series: the analytical mu leaves the bounds, the
    numerical refinement runs; the synthetic generator's path starts at
    theta and has the requested length (its normals are Philox draws, not
    the reference's)."""
    X = np.full(60, 3.0) + rng.normal(0, 1e-9, 60)
    want = jcal.OUFitter().fit(X)
    got = tcal.OUFitter(device="cpu", dtype=torch.float64).fit(X)
    assert got.success == want.success and got.message == want.message
    data = tcal.OUFitter.generate_synthetic_data(n_points=200, theta=1.5, device="cpu",
                                                 dtype=torch.float64)
    assert data.shape == (201,) and data[0] == 1.5 and np.all(np.isfinite(data))


def _ou_paths(n_paths=1024, steps=252, seed=0, theta=100.0, mu=5.0, sigma=2.0):
    """The card smoke's OU(100, 5, 2) fan (``chip_smoke.ar1_fit_mean_mu``):
    numpy exact discretisation from theta over one year, (n_paths, steps + 1)."""
    rng = np.random.default_rng(seed)
    a = np.exp(-mu / steps)
    s = np.sqrt(sigma**2 * (1.0 - np.exp(-2.0 * mu / steps)) / (2.0 * mu))
    z = rng.standard_normal((n_paths, steps))
    x = np.empty((n_paths, steps + 1))
    x[:, 0] = theta
    for i in range(steps):
        x[:, i + 1] = theta + (x[:, i] - theta) * a + s * z[:, i]
    return x


@pytest.fixture(scope="module")
def ou_fan():
    """The fan and the reference's float64 fits of it (``fit_mle`` vmapped,
    the analytical ``fit_batch``)."""
    x = _ou_paths()
    return (x, jax.vmap(lambda s: jou.fit_mle(s, DT))(jnp.asarray(x)).params,
            jcal.OUFitter().fit_batch(x))


F32_GATES = (("theta", 1e-5), ("mu", 1e-3), ("sigma", 1e-4))


@pytest.mark.parametrize("fit", ["fit_mle", "fit_batch"])
def test_float32_fits_hold_float64_on_every_path(ou_fan, fit):
    """Every path of the fan fitted in float32 by the port against the
    reference in float64: theta 1e-5, mu 1e-3, sigma 1e-4 relative."""
    x, want_mle, want_batch = ou_fan
    x32 = torch.as_tensor(x, dtype=torch.float32)
    if fit == "fit_mle":
        got, want = tou.fit_mle(x32, DT).params, want_mle
    else:
        got, want = tcal.OUFitter(device="cpu", dtype=torch.float32).fit_batch(x32), want_batch
    for f, rtol in F32_GATES:
        assert getattr(got, f).dtype == torch.float32
        _close(getattr(got, f).double(), getattr(want, f), rtol=rtol, atol=0.0)


@pytest.mark.parametrize("seed", [42, 3])
@pytest.mark.parametrize("symbol", ["SPY", "QQQ", "IWM"])
def test_float32_fitter_on_service_series(symbol, seed):
    """``OUFitter.fit`` in float32 on the log closes that the signals
    service fits (the simulated provider at its default seed and at the
    smoke's, one year of bars): mu within 1e-3 of the reference's float64
    fit, and the same branch."""
    end = datetime.date(2026, 1, 2)
    bars = SimulatedDataProvider(seed=seed, device="cpu").get_bars(
        symbol, end - datetime.timedelta(days=365), end)
    X = np.log([b.close for b in bars])
    want = jcal.OUFitter().fit(X)
    got = tcal.OUFitter(device="cpu", dtype=torch.float32).fit(X)
    assert got.success == want.success and got.message == want.message
    _close(float(got.params.mu), float(want.params.mu), rtol=1e-3, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_constant_series_is_degenerate(dtype):
    """A constant series far from zero is degenerate in either dtype:
    ``fit_mle`` gives mu = sigma = 0 and theta = the level, the analytical
    fit its degenerate slope 0.5 and theta = the level (the raw moments of
    123.456 leave a variance of 2e-3 in float32 and 1e-11 in float64)."""
    x = torch.full((253,), 123.456, dtype=dtype)
    res = tou.fit_mle(x, DT)
    assert not bool(res.converged)
    assert float(res.params.mu) == 0.0 and float(res.params.sigma) == 0.0
    assert float(res.params.theta) == float(x[0])
    theta, mu, _ = tcal._analytical_mle(x, DT)
    assert float(theta) == float(x[0])
    _close(float(mu), np.log(2.0) / DT, rtol=1e-6, atol=0.0)


def test_interop_ou_params():
    p = interop.ou_params(jou.OUParams(1.0, 2.0, 3.0))
    assert [float(v) for v in p] == [1.0, 2.0, 3.0] and p.mu.dtype == torch.float64


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda: tcal.OUFitter(),
    lambda: tcal.OUFitter.generate_synthetic_data(n_points=10),
    lambda: tou.fit_mle([1.0, 2.0, 1.5, 1.7], DT),
    lambda: tou.OUParams(100.0, 5.0, 2.0).half_life(),
    lambda: tou.simulate(tou.OUParams(100.0, 5.0, 2.0), 100.0, 1.0, 8, torch.Generator()),
], ids=["OUFitter", "generate_synthetic_data", "fit_mle", "half_life", "simulate"])
def test_default_device_needs_the_card(no_card, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
