"""Matrix utilities for risk and portfolio analytics (twin of
``pde_tpu/utils/linalg.py``).

Covariance/correlation estimation, positive-definiteness repair, Cholesky,
safe inversion and EWMA covariance, on tensors.  A tensor input stays on
its device; a host array goes to ``device`` (the card unless the caller
names another) in its own precision.  Matrix products run in full float32
(``lm._full_fp32_matmul``: never TF32).

* ``cholesky_decomposition`` and ``solve_positive_definite`` give
  ``jnp.linalg.cholesky``'s NaN factor, and so a NaN solution, on a matrix
  that is not positive definite (``torch.linalg.cholesky`` would raise).
* ``ewma_covariance`` is one weighted sum of outer products,
  ``lam^n init + (1 - lam) sum_k lam^(n-1-k) x_k x_k^T``, where the
  reference scans the n observations.
"""

from __future__ import annotations

import torch

from ..core.precision import cholesky_nan, host_tensor

__all__ = [
    "compute_covariance",
    "covariance_to_correlation",
    "condition_number",
    "is_positive_definite",
    "safe_invert",
    "cholesky_decomposition",
    "make_positive_definite",
    "solve_positive_definite",
    "ewma_covariance",
]


def _full_fp32_matmul():
    """``lm._full_fp32_matmul``, imported at call time: ``calibrate``
    imports ``models``, which import this package's ``stats``."""
    from ..calibrate.lm import _full_fp32_matmul as region

    return region()


def _tensor(a, device) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else host_tensor(a, device)


def compute_covariance(returns, ddof: int = 1, device=None) -> torch.Tensor:
    """Sample covariance of a (n_obs, n_assets) return matrix."""
    r = _tensor(returns, device)
    x = r - torch.mean(r, dim=0, keepdim=True)
    with _full_fp32_matmul():
        return (x.T @ x) / (r.shape[0] - ddof)


def covariance_to_correlation(cov, device=None) -> torch.Tensor:
    """Convert a covariance matrix to a correlation matrix (unit diagonal)."""
    cov = _tensor(cov, device)
    d = torch.sqrt(torch.clamp_min(torch.diagonal(cov), 1e-300))
    corr = cov / torch.outer(d, d)
    eye = torch.eye(cov.shape[0], dtype=torch.bool, device=cov.device)
    return torch.where(eye, torch.ones_like(corr), corr)


def condition_number(a, device=None) -> torch.Tensor:
    """2-norm condition number via singular values."""
    s = torch.linalg.svdvals(_tensor(a, device))
    return s[0] / torch.clamp_min(s[-1], 1e-300)


def is_positive_definite(a, tol: float = 0.0, device=None) -> torch.Tensor:
    """True when all eigenvalues of the symmetric matrix exceed ``tol``."""
    a = _tensor(a, device)
    w = torch.linalg.eigvalsh(0.5 * (a + a.T))
    return torch.all(w > tol)


def safe_invert(a, ridge: float = 1e-10, device=None) -> torch.Tensor:
    """Inverse with a small ridge on the diagonal for numerical safety."""
    a = _tensor(a, device)
    return torch.linalg.inv(a + ridge * torch.eye(a.shape[0], dtype=a.dtype, device=a.device))


def cholesky_decomposition(a, device=None) -> torch.Tensor:
    """Lower-triangular Cholesky factor (NaN where ``a`` is not positive
    definite)."""
    return cholesky_nan(_tensor(a, device))


def make_positive_definite(a, min_eigenvalue: float = 1e-8, device=None) -> torch.Tensor:
    """Repair a symmetric matrix to be positive definite: clip its
    eigenvalues from below at ``min_eigenvalue`` and reconstruct."""
    a = _tensor(a, device)
    sym = 0.5 * (a + a.T)
    w, v = torch.linalg.eigh(sym)
    w = torch.clamp_min(w, min_eigenvalue)
    with _full_fp32_matmul():
        return (v * w) @ v.T


def solve_positive_definite(a, b, device=None) -> torch.Tensor:
    """Solve A x = b for SPD A via Cholesky (``b`` a vector or a matrix)."""
    a = _tensor(a, device)
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    c = cholesky_nan(a)
    rhs = b[:, None] if b.ndim == 1 else b
    y = torch.linalg.solve_triangular(c, rhs, upper=False)
    x = torch.linalg.solve_triangular(c.T, y, upper=True)
    return x[:, 0] if b.ndim == 1 else x


def ewma_covariance(returns, lam: float = 0.94, device=None) -> torch.Tensor:
    """Exponentially-weighted covariance (RiskMetrics lambda=0.94 default):
    Sigma_t = lam * Sigma_{t-1} + (1 - lam) * x_t x_t^T over the demeaned
    observations from the sample covariance, summed in closed form."""
    r = _tensor(returns, device)
    x = r - torch.mean(r, dim=0, keepdim=True)
    n = x.shape[0]
    lags = torch.arange(n - 1, -1, -1, dtype=r.dtype, device=r.device)
    weights = (1.0 - lam) * lam**lags
    with _full_fp32_matmul():
        return lam**n * compute_covariance(r) + (x * weights[:, None]).T @ x
