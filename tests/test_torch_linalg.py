"""The port's matrix utilities held against ``pde_tpu/utils/linalg.py``
under x64, on the same seeded matrices, at 1e-10 relative to each result's
largest entry (LAPACK's factorizations and the EWMA's closed-form sum round
in another order than the reference's); the reference test's own checks
ride along."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.utils import linalg as jl
from pde_tpu_torch.utils import linalg as tl

CPU = dict(device="cpu")


def _near(got, want, rel=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rel * np.abs(want).max())


@pytest.fixture
def returns(rng):
    cov_true = np.array([[0.04, 0.01], [0.01, 0.09]])
    return rng.standard_normal((2000, 2)) @ np.linalg.cholesky(cov_true).T


def _spd(n, seed, cond=1e3):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(n, n)))
    return (q * np.geomspace(1.0, 1.0 / cond, n)) @ q.T


def test_covariance_and_correlation(returns):
    cov = tl.compute_covariance(returns, **CPU)
    _near(cov, jl.compute_covariance(jnp.asarray(returns)))
    np.testing.assert_allclose(cov.numpy(), np.cov(returns.T), rtol=1e-10)
    _near(tl.compute_covariance(returns, ddof=0, **CPU),
          jl.compute_covariance(jnp.asarray(returns), ddof=0))
    corr = tl.covariance_to_correlation(cov)
    _near(corr, jl.covariance_to_correlation(jnp.asarray(cov.numpy())))
    assert torch.all(torch.diagonal(corr) == 1.0)


@pytest.mark.parametrize("lam", [0.94, 0.97])
@pytest.mark.parametrize("shape", [(500, 2), (252, 12)])
def test_ewma_covariance(shape, lam, rng):
    r = rng.normal(0.0, 0.01, shape)
    s = tl.ewma_covariance(r, lam, **CPU)
    _near(s, jl.ewma_covariance(jnp.asarray(r), lam))
    assert bool(tl.is_positive_definite(s))


def test_make_positive_definite():
    a = np.array([[1.0, 2.0], [2.0, 1.0]])  # indefinite
    assert not bool(tl.is_positive_definite(a, **CPU))
    fixed = tl.make_positive_definite(a, **CPU)
    _near(fixed, jl.make_positive_definite(jnp.asarray(a)))
    assert bool(tl.is_positive_definite(fixed, tol=0.0))
    m = np.random.default_rng(3).normal(size=(60, 60))
    _near(tl.make_positive_definite(m + m.T, 1e-3, **CPU),
          jl.make_positive_definite(jnp.asarray(m + m.T), 1e-3))


@pytest.mark.parametrize("n", [2, 40])
def test_solve_positive_definite(n):
    a = _spd(n, n)
    b = np.random.default_rng(1).normal(size=n)
    for rhs in (b, np.stack([b, 2 * b + 1], 1)):
        x = tl.solve_positive_definite(a, rhs, **CPU)
        _near(x, jl.solve_positive_definite(jnp.asarray(a), jnp.asarray(rhs)))
        np.testing.assert_allclose(a @ x.numpy(), rhs, atol=1e-10)


def test_not_positive_definite_gives_the_reference_s_nans():
    bad = np.array([[1.0, 2.0], [2.0, 1.0]])
    for got, want in ((tl.cholesky_decomposition(bad, **CPU),
                       jl.cholesky_decomposition(jnp.asarray(bad))),
                      (tl.solve_positive_definite(bad, np.ones(2), **CPU),
                       jl.solve_positive_definite(jnp.asarray(bad), jnp.ones(2)))):
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
        assert np.isnan(got.numpy()).any()


def test_cholesky_inverse_and_condition_number():
    a = _spd(30, 4)
    c = tl.cholesky_decomposition(a, **CPU)
    _near(c, jl.cholesky_decomposition(jnp.asarray(a)))
    np.testing.assert_allclose((c @ c.T).numpy(), a, atol=1e-12)
    _near(tl.safe_invert(a, **CPU), jl.safe_invert(jnp.asarray(a)), 1e-9)
    assert abs(float(tl.condition_number(a, **CPU)) - float(jl.condition_number(
        jnp.asarray(a)))) <= 1e-10 * 1e3
    inv = tl.safe_invert(np.diag([2.0, 4.0]), **CPU).numpy()
    np.testing.assert_allclose(inv, [[0.5, 0.0], [0.0, 0.25]], atol=1e-8)


def test_tensor_inputs_stay_where_they_are():
    a = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float32)
    x = tl.solve_positive_definite(a, torch.tensor([1.0, 2.0]))
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    np.testing.assert_allclose((a @ x).numpy(), [1.0, 2.0], atol=1e-6)
