"""The port's tridiagonal solvers held against ``pde_tpu/ops/tridiag.py``.

Seeded, diagonally dominant systems go through both packages in float64.
Both run the same recurrences in the same order, so the gate is 1e-12
(relative, on solutions of order one): round-off only.  Gradients through
the Thomas solvers match ``jax.grad`` at 1e-10 relative.  The batched
Thomas kernel's plain twin (K5) is held against the reference's Pallas
kernel in interpret mode at its own float32 gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pde_tpu.ops import tridiag as jt
from pde_tpu_torch.ops import tridiag as tt

GATE = dict(rtol=1e-12, atol=1e-12)
# float32 kernel twin vs the reference kernel (tests/test_tridiag.py:190)
K5_GATE = dict(rtol=2e-4, atol=2e-4)


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


def test_k5_twin_matches_thomas_pallas(rng):
    """The batched Thomas kernel branch (the reference's thomas_pallas, K5)
    runs its plain twin on a CPU tensor, held against thomas_pallas in
    interpret mode (tests/test_tridiag.py:179-190) and counting no launch."""
    B, n = 70, 40
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    sys_ = (f32(rng.uniform(-1, 1, (B, n - 1))), f32(4.0 + rng.uniform(0, 1, (B, n))),
            f32(rng.uniform(-1, 1, (B, n - 1))), f32(rng.uniform(-2, 2, (B, n))))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jt.thomas_pallas(*map(jnp.asarray, sys_)))
    before = tt.thomas_batched.launches
    got = tt.tridiagonal_solve(*_t(*sys_), use_kernel=True)
    assert got.shape == (B, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **K5_GATE)
    np.testing.assert_array_equal(got.numpy(), tt.thomas_batched(*_t(*sys_)).numpy())
    assert tt.thomas_batched.launches == before


def test_kernel_branch_broadcasts_shared_bands(rng):
    """Shared 1-D bands (heston_adi's v sweep) are broadcast to one set per
    system before the kernel (tests/test_tridiag.py:203-220)."""
    B, n = 6, 24
    lower, upper = rng.uniform(-1, 1, n - 1), rng.uniform(-1, 1, n - 1)
    diag = 4 + rng.uniform(0, 1, n)
    rhs = rng.uniform(-1, 1, (B, n)).astype(np.float32)
    want = np.asarray(jt.thomas(lower, diag, upper, rhs))
    got = tt.tridiagonal_solve(*(torch.as_tensor(a, dtype=torch.float32)
                                 for a in (lower, diag, upper)),
                               torch.as_tensor(rhs), use_kernel=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def test_thomas_batched_rejects_bad_inputs(rng):
    sys_ = [torch.as_tensor(a, dtype=torch.float32) for a in _system(rng, (3,), 8)]
    with pytest.raises(ValueError):  # wrong shape
        tt.thomas_batched(sys_[0][:, :-1], *sys_[1:])
    with pytest.raises(ValueError):  # float64
        tt.thomas_batched(*sys_[:3], sys_[3].double())
    with pytest.raises(ValueError):  # neither a CUDA nor a CPU tensor
        tt.thomas_batched(*(a.to("meta") for a in sys_))


def _weights(rng, shape):
    return rng.normal(size=shape)


@pytest.mark.parametrize("fn", ["thomas", "thomas_factor", "thomas_solve_factored"])
def test_gradients_match_jax(rng, fn):
    """torch.autograd through each Thomas function against jax.grad of the
    same weighted sum, float64, for the bands and the right-hand side."""
    B, n = 3, 9
    lower, diag, upper, rhs = _system(rng, (B,), n)
    w = _weights(rng, (2, B, n))

    def loss(mod, lo, di, up, b, to):
        if fn == "thomas":
            return (to(w[0]) * mod.thomas(lo, di, up, b)).sum()
        factors = mod.thomas_factor(lo, di, up)
        if fn == "thomas_factor":
            return (to(w[0]) * factors.cp).sum() + (to(w[1]) * factors.inv_m).sum()
        return (to(w[0]) * mod.thomas_solve_factored(factors, b)).sum()

    # float64: the suite runs JAX with jax_enable_x64 (tests/conftest.py)
    want = jax.grad(lambda *a: loss(jt, *a, jnp.asarray), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (lower, diag, upper, rhs)))
    args = [torch.as_tensor(a).requires_grad_() for a in (lower, diag, upper, rhs)]
    got = torch.autograd.grad(loss(tt, *args, torch.as_tensor), args, allow_unused=True)
    for name, g, h in zip(("lower", "diag", "upper", "rhs"), got, want):
        if fn == "thomas_factor" and name == "rhs":
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(h), rtol=1e-10, atol=1e-14,
                                   err_msg=name)


@pytest.mark.parametrize("n,plan", [(2, (1, 2, 3, 6144)), (5, (2, 3, 3, 6144)),
                                    (50, (16, 4, 5, 10240)), (100, (32, 4, 5, 10240)),
                                    (200, (32, 7, 7, 14336)), (3632, (32, 114, 115, 235520)),
                                    (3600, (32, 113, 113, 231424))])
def test_k5_lane_plan(n, plan):
    """K5's lane-group route: lanes per system a power of two up to 32, so
    that a chunk holds about four rows (16 at n = 50, 32 at n = 100); an
    odd chunk stride in shared memory; four operands of the block's 128 / g
    systems within a block's 227 KB, else the first design (None)."""
    want = plan if plan[3] <= 232448 else None
    assert tt._lane_plan(n) == want
    if want is not None:
        g, ch, cp, n_bytes = want
        assert g * ch >= n and cp % 2 == 1 and cp >= ch
        assert n_bytes == 4 * 4 * (128 // g) * g * cp


def test_k5_reads_operands_in_place():
    """The lane-group route takes each operand's batch stride: 0 for a band
    expanded over the batch or a single system, the row length for a
    contiguous batch; only rows that are not contiguous are copied."""
    band = torch.zeros(1, 9).expand(6, 9)
    assert tt._batch_stride(band)[1] == 0 and tt._batch_stride(band)[0] is band
    one = torch.zeros(1, 10)
    assert tt._batch_stride(one) == (one, 0)
    full = torch.zeros(6, 10)
    assert tt._batch_stride(full) == (full, 10)
    strided = torch.zeros(10, 6).T
    copy, stride = tt._batch_stride(strided)
    assert copy.is_contiguous() and stride == 10


def test_tridiagonal_solve_expands_shared_bands_in_place(rng):
    """The kernel branch hands thomas_batched shared 1-D bands expanded
    over the batch (no copy); the result equals the reference's thomas."""
    B, n = 5, 16
    lower, upper = rng.uniform(-1, 0, n - 1), rng.uniform(-1, 0, n - 1)
    diag, rhs = 3 + rng.uniform(0, 1, n), rng.normal(size=(B, n)).astype(np.float32)
    seen = []
    real = tt.thomas_batched
    try:
        tt.thomas_batched = lambda *a: (seen.extend(a), real(*a))[1]
        got = tt.tridiagonal_solve(*(torch.as_tensor(a, dtype=torch.float32)
                                     for a in (lower, diag, upper)),
                                   torch.as_tensor(rhs), use_kernel=True)
    finally:
        tt.thomas_batched = real
    assert [a.stride(0) for a in seen[:3]] == [0, 0, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.thomas(lower, diag, upper, rhs)),
                               rtol=2e-4, atol=1e-5)
