"""K3's surface route (``fused_cn_march_1d_tv_surface``) on the CPU: its
plain twin, which builds each level's bands from the surface as the kernel
does, against the lattice route's twin and against the reference; its
brackets at the surface's edges; the solver's choice of route; the
wrapper's refusals.  The CUDA kernel itself runs only on the card:
tests/test_torch_cuda.py.

Gates, each with its reason:
- surface twin vs lattice twin: bit for bit.  The twin builds each level
  with the lattice builder's own tensor ops, one level's slice at a time,
  and marches with the lattice twin's arithmetic.
- surface twin vs the reference's Pallas kernel (interpret mode) fed the
  reference's one-hot-matmul lattice: 3e-5 relative + 1e-5 absolute on
  values up to ~K, the K3 twin-vs-Pallas gate of
  tests/test_torch_local_vol_pde.py.  The reference pivots by rsqrt(den)^2,
  the port by a true IEEE divide, and its lattice's sums round in another
  order (the two lattices agree to 2e-5).
- per-node sigma vs ``_sigma_lattice_batch``: bit for bit, the same ops.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pde_tpu.models import local_vol as jlv
from pde_tpu.ops import cn1d_tv_fused as jops
from pde_tpu.solvers import local_vol_pde as jpde
from pde_tpu_torch.models import local_vol as tlv
from pde_tpu_torch.ops import cn1d_tv_fused as tops
from pde_tpu_torch.solvers import local_vol_pde as tpde

F32 = torch.float32
R, Q = 0.04, 0.01
KS = np.array([60.0, 75.0, 90.0, 100.0, 110.0, 130.0, 150.0], np.float32)
TS = np.array([0.1, 0.5, 1.0, 2.0], np.float32)
VOLS = (0.15 + 0.2 * np.random.default_rng(11).random((4, 7))).astype(np.float32)
SIZES = {"41x20_B11": (41, 20, 11), "200x100_B8": (200, 100, 8)}


def _interp():
    return tlv.SurfaceInterpolator(KS, TS, VOLS, device="cpu", dtype=F32)


def _surface(interp):
    return interp.log_k, interp.t, interp.vols


@functools.lru_cache(maxsize=None)
def _book(size):
    """A seeded book of the size (strikes 70-140, maturities 0.05-2.5, so
    that levels fall before the first pillar and beyond the last) and the
    reference's lattice for it, shared by the cases of one size."""
    n, n_time, B = SIZES[size]
    rng = np.random.default_rng(n)
    K = rng.uniform(70.0, 140.0, B).astype(np.float32)
    T = rng.uniform(0.05, 2.5, B).astype(np.float32)
    pay, sc, sg, dx = tpde._grid_inputs(torch.as_tensor(K), torch.as_tensor(T),
                                        torch.zeros(B), torch.zeros(B), R, Q, n, n_time,
                                        0.2, 5.0)
    lattice = np.asarray(jpde._band_lattice_batch_mxu(
        jlv.SurfaceInterpolator(jnp.asarray(KS), jnp.asarray(TS), jnp.asarray(VOLS)),
        jnp.asarray(sg.numpy()), dx, jnp.asarray(T), R, Q, n_time))
    return torch.as_tensor(K), torch.as_tensor(T), lattice


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("scheme", ["crank_nicolson", "implicit"])
@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("is_call", [True, False])
def test_surface_twin_matches_lattice_twin_and_reference(size, scheme, american, is_call):
    n, n_time, B = SIZES[size]
    w = {"crank_nicolson": 0.5, "implicit": 1.0}[scheme]
    K, T, ref_lattice = _book(size)
    call_f, amer_f = torch.full((B,), float(is_call)), torch.full((B,), float(american))
    interp = _interp()
    pay, bands, sc, sg = tpde._march_inputs(interp, K, T, call_f, amer_f, R, Q, n, n_time,
                                            0.2, 5.0)
    dx = tpde._grid_inputs(K, T, call_f, amer_f, R, Q, n, n_time, 0.2, 5.0)[3]
    before = tops.fused_cn_march_1d_tv_surface.launches
    got = tops.fused_cn_march_1d_tv_surface(pay, torch.log(sg), sc, T, *_surface(interp), n,
                                            n_time, dx, R, Q, w)
    assert got.shape == (n, B) and got.dtype == F32
    # a CPU tensor runs the plain twin, never the kernel
    assert tops.fused_cn_march_1d_tv_surface.launches == before
    lattice = tops.fused_cn_march_1d_tv(pay, bands, sc, n, n_time, w)
    assert torch.equal(got, lattice)
    want = np.asarray(jops.fused_cn_march_1d_tv(pay.numpy(), ref_lattice, sc.numpy(),
                                                n_space=n, n_time=n_time, w=w,
                                                interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-5)


def _edge_case(case):
    """The surface, its vols, the spot nodes (n, B) and the maturities (B,)
    of one edge case."""
    interp = _interp()
    vols = interp.vols
    ks = torch.as_tensor(KS)
    if case == "on_strike_knots":
        # ln of the knots' own float32 strikes: x equals each ln K knot
        sg = ks[:, None].expand(len(KS), 3).contiguous()
        T = torch.tensor([0.05, 0.75, 3.0])
    elif case == "below_first_pillar":
        sg = torch.tensor([1.0, 20.0, 45.0, 59.9])[:, None].expand(4, 3).contiguous()
        T = torch.tensor([0.3, 0.75, 1.5])
    elif case == "above_last_pillar":
        sg = torch.tensor([150.1, 200.0, 400.0, 1e4])[:, None].expand(4, 3).contiguous()
        T = torch.tensor([0.3, 0.75, 1.5])
    else:
        sg = torch.tensor([50.0, 60.0, 95.0, 100.0, 142.0, 170.0])[:, None].expand(
            6, 3).contiguous()
        T = {"levels_t0_and_T": torch.tensor([0.3, 0.75, 1.5]),
             "T_beyond_last_maturity": torch.tensor([2.0, 3.0, 7.5]),
             "T_before_first_maturity": torch.tensor([0.01, 0.05, 0.1])}[case]
    return interp, vols, sg, T


EDGE_CASES = ["on_strike_knots", "below_first_pillar", "above_last_pillar",
              "levels_t0_and_T", "T_beyond_last_maturity", "T_before_first_maturity"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_surface_sigma_at_the_edges(case):
    """The surface route's per-node sigma, at every level, equals
    ``_sigma_lattice_batch``'s bit for bit, and the edge itself reads as the
    lattice's semantics say: a node on a knot takes that knot's column
    (searchsorted right), a node beyond a pillar the flat pillar, a level
    before the first maturity or beyond the last the flat row."""
    n_time = 8
    interp, vols, sg, T = _edge_case(case)
    levels = tops._SurfaceLevels(torch.log(sg), T, T / n_time, *_surface(interp),
                                 dx=0.1, r=R, q=Q)
    want = tpde._sigma_lattice_batch(interp, sg, T, n_time)
    for j in range(n_time + 1):
        assert torch.equal(levels.sigma(j), want[j]), j
    last = n_time        # level nT is t = 0, level 0 is t = T
    if case == "on_strike_knots":
        # at t = 0 every maturity sits before the first pillar: vols[0]
        np.testing.assert_array_equal(levels.sigma(last)[:, 0].numpy(), vols[0].numpy())
        np.testing.assert_array_equal(levels.ix[0].numpy(), [0, 1, 2, 3, 4, 5, 5])
    elif case == "below_first_pillar":
        assert bool((levels.ix == 0).all()) and bool((levels.wx == 0).all())
        assert torch.equal(levels.sigma(last), vols[0, 0].expand(4, 3))
    elif case == "above_last_pillar":
        assert bool((levels.ix == len(KS) - 2).all()) and bool((levels.wx == 1).all())
        assert torch.equal(levels.sigma(last), vols[0, -1].expand(4, 3))
    elif case == "levels_t0_and_T":
        # t = T at level 0 (0.75: halfway between the pillars 0.5 and 1.0),
        # t = 0 at level nT (before the first pillar)
        x = tpde._sigma_lattice_batch(interp, sg, T, 1)
        assert torch.equal(levels.sigma(0), x[0]) and torch.equal(levels.sigma(last), x[1])
        mid = 0.5 * vols[1] + 0.5 * vols[2]
        np.testing.assert_allclose(levels.sigma(0)[3, 1].numpy(), mid[3].numpy(), rtol=1e-6)
        np.testing.assert_allclose(levels.sigma(last)[3].numpy(), vols[0, 3].numpy(),
                                   rtol=1e-6)
    elif case == "T_beyond_last_maturity":
        # at level 0 each t = T is at or beyond the last pillar: vols[-1]
        np.testing.assert_allclose(levels.sigma(0)[3].numpy(), vols[-1, 3].numpy(),
                                   rtol=1e-6)
    else:
        # every level lies at or before the first pillar: vols[0]
        for j in range(n_time + 1):
            np.testing.assert_allclose(levels.sigma(j)[3].numpy(), vols[0, 3].numpy(),
                                       rtol=1e-6)


def _spy(monkeypatch):
    calls = []
    for name in ("fused_cn_march_1d_tv", "fused_cn_march_1d_tv_surface"):
        real = getattr(tpde, name)
        monkeypatch.setattr(tpde, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    return calls


BIG_SURFACE = dict(strikes=np.linspace(50.0, 200.0, 240), maturities=np.linspace(0.1, 2.0, 240))


@pytest.mark.parametrize("vol_fn,route,n_space,want", [
    ("surface", "fused", 24, "fused_cn_march_1d_tv_surface"),
    ("surface", "pallas", 24, "fused_cn_march_1d_tv_surface"),
    ("callable", "fused", 24, "fused_cn_march_1d_tv"),
    ("surface", "scan", 24, None),
    ("surface", "fused", 519, "fused_cn_march_1d_tv"),
    ("big_surface", "fused", 24, "fused_cn_march_1d_tv"),
])
def test_solver_route_follows_its_input(monkeypatch, vol_fn, route, n_space, want):
    """A SurfaceInterpolator book on the fused route marches on the surface
    route; a callable, the scan route, a grid too long for the route's block
    and a surface too large for it build the lattice.  Every route prices
    the book alike."""
    interp = _interp()
    fn = {"surface": interp, "callable": lambda s, t: interp(s, t),
          "big_surface": tlv.SurfaceInterpolator(
              BIG_SURFACE["strikes"], BIG_SURFACE["maturities"],
              np.full((240, 240), 0.2), device="cpu", dtype=F32)}[vol_fn]
    kw = dict(K=[90.0, 110.0], T=[0.5, 1.0], is_call=[1.0, 0.0], american=[0.0, 1.0],
              r=R, q=Q, n_space=n_space, n_time=2, device="cpu")
    calls = _spy(monkeypatch)
    got = tpde.solve_fused_batch(fn, 100.0, route=route, **kw)
    assert calls == ([want] if want else [])
    if vol_fn == "surface" and route != "scan":
        lattice = tpde.solve_fused_batch(lambda s, t: interp(s, t), 100.0, route=route, **kw)
        assert torch.isfinite(got.price).all()
        np.testing.assert_allclose(got.price.numpy(), lattice.price.numpy(), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("n,n_k,n_t,n_bytes,fits", [
    (3, 24, 6, 1528, True), (200, 24, 6, 55096, True), (518, 24, 6, 141592, True),
    (519, 24, 6, 141880, False), (200, 200, 200, 216000, True), (200, 240, 240, None, False),
    (200, 1, 6, 54452, False), (200, 24, 1, 54596, False)])
def test_surface_route_shared_memory(n, n_k, n_t, n_bytes, fits):
    """A surface-route block holds the surface and, per option, 8 n floats
    and n 16-bit strike brackets, up to the 227 KB a block can have.  The
    route runs where the lattice route runs the same warp march (n <= 518)
    on a surface of two knots an axis or more; other books build the
    lattice."""
    assert tops._surface_smem_bytes(n, n_k, n_t) == n_bytes
    assert tops.surface_route_fits(n, n_k, n_t) == fits


def test_surface_route_rejects_bad_inputs():
    interp = _interp()
    K, T = torch.tensor([90.0, 110.0, 100.0]), torch.tensor([0.5, 1.0, 1.5])
    z = torch.zeros(3)
    pay, sc, sg, dx = tpde._grid_inputs(K, T, z, z, R, Q, 8, 2, 0.2, 5.0)
    args = [pay, torch.log(sg), sc, T, *_surface(interp)]
    kw = dict(n_space=8, n_time=2, dx=dx, r=R, q=Q)
    march = tops.fused_cn_march_1d_tv_surface
    with pytest.raises(ValueError):  # wrong shape
        march(*args, **dict(kw, n_space=9))
    for i in range(len(args)):
        bad = list(args)
        bad[i] = args[i].double()
        with pytest.raises(ValueError):  # float64
            march(*bad, **kw)
    with pytest.raises(ValueError):  # not contiguous
        march(args[0].T.contiguous().T, *args[1:], **kw)
    with pytest.raises(ValueError):  # neither a CUDA nor a CPU tensor
        march(*(a.to("meta") for a in args), **kw)
    with pytest.raises(ValueError):  # a surface of one maturity
        march(*args[:5], args[5][:1], args[6][:1], **kw)
    leaf = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        march(leaf, *args[1:], **kw)
    with torch.no_grad():
        assert march(leaf, *args[1:], **kw).shape == (8, 3)

