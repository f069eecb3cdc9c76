"""The port's local-vol PDE slice held against ``pde_tpu``.

K3 (``fused_cn_march_1d_tv``): the JAX Pallas kernel in interpret mode
against the port's plain twin on identical seeded inputs; the gather band
lattice against the reference's one-hot-matmul lattice; then the whole
``solve_fused_batch`` (both routes) and ``solve`` in both packages.  The
CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.

Gates, each with its reason:
- K3 twin vs Pallas kernel, float32: 3e-5 relative (+1e-5 absolute on
  values up to ~K).  The reference pivots by rsqrt(den)^2, the port by a
  true IEEE divide; over 8 steps that leaves a few float32 ulps.
- lattice: 2e-5, the reference test's own gate for its two lattice
  builders (tests/test_local_vol.py:291).
- book prices, float32: 3e-5 relative / 2e-5 absolute, the reference's
  fused-vs-scan gate (tests/test_local_vol.py:205-217) — the two packages
  march in float32 in the same order, but differ in the pivot and in the
  order of the lattice's sums.
- ``solve`` in float64: 1e-10; the same scan in the same order.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pde_tpu.models import local_vol as jlv
from pde_tpu.ops import cn1d_tv_fused as jops
from pde_tpu.solvers import local_vol_pde as jpde
from pde_tpu_torch import interop
from pde_tpu_torch.models import local_vol as tlv
from pde_tpu_torch.ops import cn1d_tv_fused as tops
from pde_tpu_torch.solvers import local_vol_pde as tpde

F32 = torch.float32
S0, R, Q = 100.0, 0.04, 0.01
BOOK_GATE = dict(rtol=3e-5, atol=2e-5)


def _grid(rng, dtype=np.float32):
    Ks = np.linspace(60.0, 150.0, 9)
    Ts = np.array([0.1, 0.5, 1.0, 2.0])
    return Ks.astype(dtype), Ts.astype(dtype), (0.15 + 0.2 * rng.random((4, 9))).astype(dtype)


def _k3_inputs(rng, n, n_time, B):
    """A seeded mixed book on a seeded surface, as K3's (pay, bands, sc),
    built by the port's own operator assembly."""
    Ks, Ts, grid = _grid(rng)
    interp = tlv.SurfaceInterpolator(Ks, Ts, grid, device="cpu", dtype=F32)
    t = lambda a: torch.as_tensor(a, dtype=F32)  # noqa: E731
    K = t(rng.uniform(80.0, 120.0, B))
    T = t(rng.uniform(0.25, 1.5, B))
    call = t(rng.uniform(size=B) < 0.5)
    amer = t(np.arange(B) % 2 == 0)
    pay, bands, sc, _ = tpde._march_inputs(interp, K, T, call, amer, R, Q, n, n_time,
                                           0.2, 5.0)
    return pay, bands, sc


@pytest.mark.parametrize("w", [0.5, 1.0])
def test_k3_plain_matches_pallas(rng, w):
    n, n_time, B = 32, 8, 5
    pay, bands, sc = _k3_inputs(rng, n, n_time, B)
    want = np.asarray(jops.fused_cn_march_1d_tv(
        pay.numpy(), bands.numpy(), sc.numpy(), n_space=n, n_time=n_time, w=w,
        interpret=True))
    before = tops.fused_cn_march_1d_tv.launches
    got = tops.fused_cn_march_1d_tv(pay, bands, sc, n_space=n, n_time=n_time, w=w)
    assert got.shape == want.shape == (n, B) and got.dtype == F32
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-5)
    # a CPU tensor runs the plain twin, never the kernel
    assert tops.fused_cn_march_1d_tv.launches == before


def test_k3_rejects_bad_inputs(rng):
    pay, bands, sc = _k3_inputs(rng, 8, 2, 3)
    kw = dict(n_space=8, n_time=2)
    with pytest.raises(ValueError):  # wrong shape
        tops.fused_cn_march_1d_tv(pay, bands, sc, n_space=9, n_time=2)
    with pytest.raises(ValueError):  # float64
        tops.fused_cn_march_1d_tv(pay, bands.double(), sc, **kw)
    with pytest.raises(ValueError):  # not contiguous
        tops.fused_cn_march_1d_tv(pay.T.contiguous().T, bands, sc, **kw)
    with pytest.raises(ValueError):  # neither a CUDA nor a CPU tensor
        tops.fused_cn_march_1d_tv(*(a.to("meta") for a in (pay, bands, sc)), **kw)


def test_gather_lattice_matches_mxu_lattice():
    """The gather lattice against the reference's one-hot-matmul lattice,
    with nodes beyond the surface's strikes and times beyond its pillars
    (the reference test's setup, tests/test_local_vol.py:262-292)."""
    Ks = np.linspace(60.0, 150.0, 17).astype(np.float32)
    Ts = np.linspace(0.1, 2.0, 9).astype(np.float32)
    grid = (0.2 + 0.05 * np.random.default_rng(5).random((9, 17))).astype(np.float32)
    n, n_time = 64, 12
    K = np.array([70.0, 95.0, 100.0, 120.0, 155.0], np.float32)
    T = np.array([0.05, 0.5, 1.0, 1.9, 2.4], np.float32)
    x = np.linspace(math.log(0.2), math.log(5.0), n).astype(np.float32)
    dx = float(x[1] - x[0])
    sg = np.exp(x)[:, None] * K[None, :]
    want = np.asarray(jpde._band_lattice_batch_mxu(
        jlv.SurfaceInterpolator(jnp.asarray(Ks), jnp.asarray(Ts), jnp.asarray(grid)),
        jnp.asarray(sg), dx, jnp.asarray(T), 0.04, 0.01, n_time))
    got = tpde._band_lattice_batch(
        tlv.SurfaceInterpolator(Ks, Ts, grid, device="cpu", dtype=F32),
        torch.as_tensor(sg), dx, torch.as_tensor(T), 0.04, 0.01, n_time)
    assert got.shape == want.shape == (n_time + 1, 3 * n, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # and the per-option callable route builds the same lattice
    interp = tlv.SurfaceInterpolator(Ks, Ts, grid, device="cpu", dtype=F32)
    generic = tpde._book_bands(lambda s, t: interp(s, t), torch.as_tensor(sg), dx,
                               torch.as_tensor(T), 0.04, 0.01, n_time)
    np.testing.assert_allclose(generic.numpy(), got.numpy(), rtol=2e-5, atol=2e-5)


_MIXED = dict(K=[90.0, 100.0, 110.0, 95.0, 120.0], T=[0.5, 1.0, 1.5, 0.75, 0.3],
              is_call=[1.0, 0.0, 1.0, 0.0, 0.0], american=[0.0, 1.0, 0.0, 1.0, 1.0])


@pytest.mark.parametrize("route", ["fused", "scan"])
@pytest.mark.parametrize("scheme", ["crank_nicolson", "implicit"])
def test_solve_fused_batch_mixed_book(rng, route, scheme):
    """A mixed book (strikes, maturities, calls and puts, European and
    American) on an interpolated surface, both routes against the
    reference's same route."""
    Ks, Ts, grid = _grid(rng, np.float64)
    kw = dict(r=R, q=Q, n_space=48, n_time=12, scheme=scheme,
              **{k: np.array(v) for k, v in _MIXED.items()})
    jint = jlv.SurfaceInterpolator(jnp.asarray(Ks, jnp.float32), jnp.asarray(Ts, jnp.float32),
                                   jnp.asarray(grid, jnp.float32))
    want = jpde.solve_fused_batch(jint, S0, interpret=True,
                                  route="pallas" if route == "fused" else "scan", **kw)
    got = tpde.solve_fused_batch(interop.surface_interpolator(jint, dtype=F32), S0,
                                 route=route, device="cpu", **kw)
    assert got.price.shape == (5,) and got.prices.shape == (5, 48)
    for f in ("price", "delta", "gamma", "prices", "spot_grid"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   err_msg=f, **BOOK_GATE)
    np.testing.assert_array_equal(got.early_exercise_optimal.numpy(),
                                  np.asarray(want.early_exercise_optimal))


def test_solve_fused_matches_its_book_lane(rng):
    Ks, Ts, grid = _grid(rng, np.float64)
    interp = tlv.SurfaceInterpolator(Ks, Ts, grid, device="cpu", dtype=F32)
    kw = dict(r=R, q=Q, n_space=40, n_time=10, device="cpu")
    book = tpde.solve_fused_batch(interp, S0, K=[95.0, 105.0], T=[1.0, 0.5],
                                  is_call=[0.0, 1.0], american=[1.0, 0.0], **kw)
    one = tpde.solve_fused(interp, S0, K=105.0, T=0.5, is_call=True, american=False, **kw)
    for a, b in zip(one, book):
        np.testing.assert_array_equal(a.numpy(), b[1].numpy())
    with pytest.raises(ValueError, match="route"):
        tpde.solve_fused_batch(interp, S0, K=100.0, T=1.0, route="mxu", **kw)


@pytest.mark.parametrize("american,is_call", [(False, True), (True, False)])
def test_solve_matches_reference_f64(rng, american, is_call):
    """The single-option scan march at float64 on an interpolated surface."""
    Ks, Ts, grid = _grid(rng, np.float64)
    jint = jlv.SurfaceInterpolator(jnp.asarray(Ks), jnp.asarray(Ts), jnp.asarray(grid))
    kw = dict(K=100.0, T=1.0, r=R, q=Q, is_call=is_call, american=american,
              n_space=40, n_time=16)
    want = jax.jit(lambda: jpde.solve(jint, S0, **kw))()
    got = tpde.solve(interop.surface_interpolator(jint), S0, device="cpu",
                     dtype=torch.float64, **kw)
    assert got.prices.dtype == torch.float64
    for f in ("price", "delta", "gamma", "prices", "spot_grid"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-10, atol=1e-10, err_msg=f)
    assert bool(got.early_exercise_optimal) == bool(want.early_exercise_optimal)


def test_low_vol_high_rate_book():
    """The convection-dominated stress book of tests/test_local_vol.py:219-240:
    very low local vol with a large drift on a coarse grid.  Both routes of
    the port stay finite, agree with each other at the reference's own
    2e-4 gate, and with the reference's scan route."""
    kw = dict(r=0.12, q=0.0, n_space=96, n_time=24, K=np.array([95.0, 100.0, 105.0, 100.0]),
              T=np.array([0.5, 1.0, 1.5, 2.0]), is_call=np.array([1.0, 0.0, 1.0, 0.0]),
              american=np.array([0.0, 1.0, 0.0, 1.0]))
    fused = tpde.solve_fused_batch(lambda s, t: torch.full_like(s, 0.03), S0,
                                   route="fused", device="cpu", **kw)
    scan = tpde.solve_fused_batch(lambda s, t: torch.full_like(s, 0.03), S0,
                                  route="scan", device="cpu", **kw)
    want = jpde.solve_fused_batch(lambda s, t: jnp.full_like(s, 0.03), S0, route="scan",
                                  **kw)
    assert np.all(np.isfinite(fused.price.numpy()))
    np.testing.assert_allclose(fused.price.numpy(), scan.price.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(scan.price.numpy(), np.asarray(want.price), **BOOK_GATE)


def test_solve_differentiates_in_s0_and_r(rng):
    """local_vol_pde.solve is differentiable by autograd (its Thomas solves
    write no tensor that is read later): d price / d S0 and d price / d r
    in float64 against jax.grad of the reference's solve, 1e-8 relative."""
    Ks, Ts, grid = _grid(rng, np.float64)
    jint = jlv.SurfaceInterpolator(jnp.asarray(Ks), jnp.asarray(Ts), jnp.asarray(grid))
    kw = dict(K=100.0, T=1.0, q=Q, is_call=False, n_space=40, n_time=16)
    want = jax.grad(lambda s0, r: jpde.solve(jint, s0, r=r, **kw).price, argnums=(0, 1))(
        S0, R)
    s0, r = (torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (S0, R))
    price = tpde.solve(interop.surface_interpolator(jint), s0, r=r, device="cpu",
                       dtype=torch.float64, **kw).price
    got = torch.autograd.grad(price, (s0, r))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-8)
    assert float(got[0]) < 0  # a put falls with the spot


@pytest.mark.parametrize("n,n_bytes", [(3, 1344), (200, 89600), (518, 232064), (519, None)])
def test_k3_warp_route_shared_memory(n, n_bytes):
    """The warp route's block holds a ring of three band levels of its
    eight options and five rows per option: 112 n floats, up to the 227 KB
    a block can have; longer lattices run the first design."""
    assert tops._smem_bytes(n) == n_bytes
