"""The port's tridiagonal solvers held against ``pde_tpu/ops/tridiag.py``.

Seeded, diagonally dominant systems go through both packages in float64.
Both run the same recurrences in the same order, so the gate is 1e-12
(relative, on solutions of order one): round-off only.
"""

import numpy as np
import pytest
import torch

from pde_tpu.ops import tridiag as jt
from pde_tpu_torch.ops import tridiag as tt

GATE = dict(rtol=1e-12, atol=1e-12)


def _system(rng, batch, n, shared_bands=False):
    """Diagonally dominant bands and a right-hand side; with
    ``shared_bands`` the bands are 1-D and broadcast over the batch."""
    band = () if shared_bands else batch
    lower = rng.uniform(-1.0, 0.0, band + (n - 1,))
    upper = rng.uniform(-1.0, 0.0, band + (n - 1,))
    diag = 2.5 + rng.uniform(0.0, 1.0, band + (n,))
    rhs = rng.normal(size=batch + (n,))
    return lower, diag, upper, rhs


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("batch,n,shared", [((), 7, False), ((5,), 33, False),
                                            ((3, 4), 16, False), ((6,), 20, True)])
def test_thomas_matches_reference(rng, batch, n, shared):
    sys_ = _system(rng, batch, n, shared)
    want = np.asarray(jt.thomas(*sys_))
    got = tt.thomas(*_t(*sys_))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **GATE)


@pytest.mark.parametrize("shared", [False, True])
def test_factored_thomas_matches_reference(rng, shared):
    lower, diag, upper, rhs = _system(rng, (4,), 25, shared)
    jf = jt.thomas_factor(lower, diag, upper)
    tf = tt.thomas_factor(*_t(lower, diag, upper))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GATE)
    want = np.asarray(jt.thomas_solve_factored(jf, rhs))
    got = tt.thomas_solve_factored(tf, torch.as_tensor(rhs))
    np.testing.assert_allclose(got.numpy(), want, **GATE)
    # and it solves the same system as the unfactored recurrence
    np.testing.assert_allclose(got.numpy(), tt.thomas(*_t(lower, diag, upper, rhs)).numpy(),
                               **GATE)


@pytest.mark.parametrize("batch,n", [((), 37), ((2,), 64), ((3,), 5)])
def test_pcr_matches_reference(rng, batch, n):
    sys_ = _system(rng, batch, n)
    want = np.asarray(jt.pcr(*sys_))
    got = tt.pcr(*_t(*sys_))
    np.testing.assert_allclose(got.numpy(), want, **GATE)
    np.testing.assert_allclose(got.numpy(), tt.thomas(*_t(*sys_)).numpy(), rtol=1e-10,
                               atol=1e-10)


def test_tridiagonal_solve_dispatch(rng):
    # few, very long systems -> PCR (the reference's rule)
    long_sys = _system(rng, (2,), 8192)
    np.testing.assert_array_equal(tt.tridiagonal_solve(*_t(*long_sys)).numpy(),
                                  tt.pcr(*_t(*long_sys)).numpy())
    np.testing.assert_allclose(tt.tridiagonal_solve(*_t(*long_sys)).numpy(),
                               np.asarray(jt.tridiagonal_solve(*long_sys)), **GATE)
    # a CPU batch -> Thomas
    sys_ = _system(rng, (4,), 12)
    np.testing.assert_array_equal(tt.tridiagonal_solve(*_t(*sys_)).numpy(),
                                  tt.thomas(*_t(*sys_)).numpy())


def test_k5_branch_is_not_ported(rng):
    """The batched Thomas kernel branch (the reference's thomas_pallas, K5)
    raises rather than falling back."""
    sys_ = tuple(torch.as_tensor(a, dtype=torch.float32)
                 for a in _system(rng, (4,), 12))
    with pytest.raises(NotImplementedError, match="K5 thomas_pallas not ported yet"):
        tt.tridiagonal_solve(*sys_, use_kernel=True)
