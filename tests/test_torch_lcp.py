"""The port's LCP solvers held against ``pde_tpu/solvers/lcp.py``.

Seeded M-matrix LCPs go through both packages.  Gates, each with its
reason:
- ``projected_sor``, ``brennan_schwartz`` and its factor/apply pair in
  float64: 1e-10; the same sweeps and eliminations in the same order.
- K6 (``projected_sor_batched``): its plain twin against the reference's
  Pallas kernel in interpret mode, float32, at the reference test's own
  5e-5 absolute (tests/test_lcp.py:121-134).
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.solvers import lcp as jl
from pde_tpu_torch.solvers import lcp as tl

GATE = dict(rtol=1e-10, atol=1e-10)


def _lcp(rng, batch, n, lo=-0.4, hi=-0.1):
    """Diagonally dominant bands (an M-matrix), right-hand side, obstacle."""
    lower = rng.uniform(lo, hi, batch + (n - 1,))
    upper = rng.uniform(lo, hi, batch + (n - 1,))
    diag = 2.0 + rng.uniform(0, 1, batch + (n,))
    b = rng.uniform(-1, 1, batch + (n,))
    g = rng.uniform(-0.5, 0.5, batch + (n,))
    return lower, diag, upper, b, g


def _t(*arrays, dtype=torch.float64):
    return tuple(torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays)


@pytest.mark.parametrize("batch,with_x0", [((), False), ((4,), False), ((3,), True)])
def test_projected_sor_matches_reference(rng, batch, with_x0):
    sys_ = _lcp(rng, batch, 33)
    x0 = rng.uniform(-1, 1, batch + (33,)) if with_x0 else None
    kw = dict(omega=1.3, n_iter=40)
    want_x, want_r = jl.projected_sor(*map(jnp.asarray, sys_),
                                      x0=None if x0 is None else jnp.asarray(x0), **kw)
    got_x, got_r = tl.projected_sor(*_t(*sys_), x0=None if x0 is None else _t(x0)[0], **kw)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **GATE)
    np.testing.assert_allclose(float(got_r), float(want_r), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("reverse", [False, True, "mixed"])
def test_brennan_schwartz_matches_reference(rng, reverse):
    """Both sweep directions, and a bool array mixing them over the batch."""
    B, n = 4, 30
    sys_ = _lcp(rng, (B,), n)
    rev = np.array([True, False, False, True]) if reverse == "mixed" else reverse
    want_x, want_r = jl.brennan_schwartz(*map(jnp.asarray, sys_), reverse=jnp.asarray(rev))
    got_x, got_r = tl.brennan_schwartz(*_t(*sys_), reverse=torch.as_tensor(rev))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **GATE)
    np.testing.assert_allclose(float(got_r), float(want_r), rtol=1e-8, atol=1e-12)


def test_brennan_schwartz_factor_apply_match_reference(rng):
    """The factor-once / apply-per-step pair, with shared 1-D bands."""
    lower, diag, upper, _, _ = _lcp(rng, (), 25)
    b, g = rng.uniform(-1, 1, (3, 25)), rng.uniform(-0.5, 0.5, (3, 25))
    jf = jl.brennan_schwartz_factor(lower, diag, upper, reverse=True)
    tf = tl.brennan_schwartz_factor(*_t(lower, diag, upper), reverse=True)
    for a, w in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GATE)
    np.testing.assert_allclose(tl.brennan_schwartz_apply(tf, *_t(b, g)).numpy(),
                               np.asarray(jl.brennan_schwartz_apply(jf, b, g)), **GATE)


def test_k6_plain_matches_pallas(rng):
    """K6's plain twin (a CPU tensor) against projected_sor_pallas in
    interpret mode; no kernel launch on the CPU."""
    B, n = 5, 64
    sys_ = _lcp(rng, (B,), n)
    f32 = tuple(jnp.asarray(a, jnp.float32) for a in sys_)
    want_x, _ = jl.projected_sor_pallas(*f32, n_iter=120, interpret=True)
    before = tl.projected_sor_batched.launches
    got_x, got_r = tl.projected_sor_batched(*_t(*sys_, dtype=torch.float32), n_iter=120)
    assert got_x.dtype == torch.float32 and got_x.shape == (B, n)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=5e-5)
    assert float(got_r) < 1e-2
    assert tl.projected_sor_batched.launches == before
    # its plain twin is the port's projected_sor in float32
    ref_x, _ = tl.projected_sor(*_t(*sys_, dtype=torch.float32), n_iter=120)
    np.testing.assert_array_equal(got_x.numpy(), ref_x.numpy())


def test_projected_sor_batched_rejects_bad_inputs(rng):
    sys_ = _t(*_lcp(rng, (2,), 8), dtype=torch.float32)
    with pytest.raises(ValueError):  # wrong shape
        tl.projected_sor_batched(sys_[0][:, :-1], *sys_[1:])
    with pytest.raises(ValueError):  # float64
        tl.projected_sor_batched(*sys_[:4], sys_[4].double())
    with pytest.raises(ValueError):  # neither a CUDA nor a CPU tensor
        tl.projected_sor_batched(*(a.to("meta") for a in sys_))
    lower, diag, upper, b, g = sys_
    with pytest.raises(ValueError):  # a start of another length
        tl.projected_sor_batched(lower, diag, upper, b, g, x0=b[:, :-1])
    with pytest.raises(ValueError):  # bands of the system's own length
        tl.projected_sor_batched(diag, diag, upper, b, g)
    with pytest.raises(ValueError):  # negative sweeps
        tl.projected_sor_batched(lower, diag, upper, b, g, n_iter=-1)
    with pytest.raises(RuntimeError, match="no backward"):
        tl.projected_sor_batched(lower, diag, upper, b.requires_grad_(), g)


@pytest.mark.parametrize("n,ch", [(2, 2), (3, 2), (33, 2), (64, 2), (65, 4), (100, 4),
                                  (150, 6), (200, 8), (256, 8), (257, None), (300, None),
                                  (512, None), (1000, None)])
def test_k6_warp_plan(n, ch):
    """K6's warp route: 2 ceil(n / 64) rows a lane, even so that a row's
    colour is fixed by its slot (8 at the bench's n = 200), at most the
    kernel's 8-row register chunk (n <= 256); longer systems take the
    first design (None)."""
    assert tl._warp_plan(n) == ch
    if ch is not None:
        assert ch % 2 == 0 and 32 * ch >= n > 32 * (ch - 2)


@pytest.mark.parametrize("n,route", [(2, "warp"), (200, "warp"), (256, "warp"),
                                     (257, "first"), (600, "first")])
def test_k6_launch_follows_the_plan(monkeypatch, n, route):
    """The card's launcher takes the warp route (which returns the residual
    itself) exactly where _warp_plan gives a chunk, from n alone; the first
    design's result gets _residual (the launchers stand in as fakes)."""
    taken = []
    x = torch.zeros((1, n))

    def first(*a):
        taken.append("first")
        return x

    monkeypatch.setattr(tl, "_launch_psor_warp",
                        lambda *a: taken.append("warp") or (x, torch.zeros(())))
    monkeypatch.setattr(tl, "_launch_psor_first", first)
    monkeypatch.setattr(tl, "_residual", lambda *a: taken.append("residual"))
    ones = torch.ones((1, n))
    tl._launch_psor(ones[:, 1:], ones, ones[:, 1:], ones, ones, None, 1.5, 4)
    assert taken == ([route] if route == "warp" else ["first", "residual"])


def test_psor_step_is_one_red_black_sweep(rng):
    """psor_step against the reference's, one sweep from a seeded start."""
    lower, diag, upper, b, g = _lcp(rng, (), 17)
    x = rng.uniform(-1, 1, 17)
    red = np.arange(17) % 2 == 0
    want = jl.psor_step(*map(jnp.asarray, (lower, diag, upper, b, g, x)), 1.5,
                        jnp.asarray(red), jnp.asarray(~red))
    got = tl.psor_step(*_t(lower, diag, upper, b, g, x), 1.5, torch.as_tensor(red),
                       torch.as_tensor(~red))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATE)
