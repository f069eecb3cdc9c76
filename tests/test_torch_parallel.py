"""``pde_tpu_torch/parallel`` (mesh, dist_tridiag, halo, adi_sharded) on
gloo ranks, held against ``pde_tpu`` (x64) on the CPU.

The port's side runs on spawned CPU ranks of one gloo group
(``tests/torch_dist_workers.py``): one spawn of four ranks a module, in a
module-scoped fixture that runs every case and returns their outputs.  A
case with P = 4 runs on the whole world; P = 2 on a (2, 2) mesh whose two
columns each run it on their own two ranks; P = 1 (the partitioned solve
and the implicit marches only: the one-rank route the card runs) on a
(1, 4) mesh.  Every rank must return the
same global result (the reference's global-out contract).  The JAX side
runs the reference's single-device solvers (and, for the calibration step,
its one-device mesh) in this process.  Gates are the reference tests'
own (``tests/test_parallel.py``):
- ``dist_tridiagonal_solve`` on batched, unbatched and broadcast bands
  against ``ops.tridiag.thomas`` at 1e-12; an indivisible n raises;
- ``sharded_bs_explicit`` against the explicit march in numpy and against
  ``bs_pde.solve(scheme="explicit")`` at 1e-9, the same for every P
  (1e-10); an indivisible grid raises;
- ``sharded_bs_solve``, European and American, against ``bs_pde.solve``:
  1e-12 on the price, 1e-10 on the grid;
- ``sharded_heston_solve``, European and Ikonen-Toivanen American, against
  ``heston_adi.solve``: 1e-11 on the price, 1e-9 on the grid, 1e-8 on the
  Greeks (the reference marks these slow; here the grids are its own and
  the ranks run them in the one spawn);
- ``sharded_calibration_step`` on (2, 2), (4, 1) and (1, 4) meshes against
  the reference's step on a one-device mesh, 8 steps, at 1e-8 (and
  descending, as the reference's own test asserts); 25 steps
  from near the truth recover v0 within 0.01 and a mean cost under 1e-4;
- ``initialize_distributed`` with two real processes: the world size, a
  bare call, a cross-process ``all_reduce``, ``make_mesh``'s default shape
  and its refusals (no card; more devices than ranks);
- ``comm_audit.audit_table`` at P = 1, 2 and 4 (the invariants of
  ``tests/test_comm_audit.py`` on the port's runtime counts): the six
  programs' counts a step equal at P = 2 and 4 on every rank, and the
  counts its docstring states; ``dist_tridiagonal_solve`` one
  ``all_gather`` and no point-to-point; no ``all-to-all``; nothing at
  P = 1; the bytes a rank sends shrinking with P where a program gathers
  sharded state and equal where it reduces statistics; the recording
  changes no result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as W

from pde_tpu.ops import tridiag as jtri
from pde_tpu.parallel import mesh as jmesh
from pde_tpu.solvers import bs_pde as jbs
from pde_tpu.solvers import heston_adi as jadi
from pde_tpu_torch.parallel import initialize_distributed
from pde_tpu_torch.solvers import bs_pde as tbs
from pde_tpu_torch.solvers import heston_adi as tadi

WORLD = 4
PS = (2, 4)
SOLVE_PS = (1,) + PS  # P = 1: the one-rank route the card runs, with no interface
RNG = np.random.default_rng(11)
N_B, B = 64, 7
BATCHED = (RNG.normal(size=(B, N_B - 1)), 4.0 + RNG.random((B, N_B)),
           RNG.normal(size=(B, N_B - 1)), RNG.normal(size=(B, N_B)))
N_U = 96
UNBATCHED = (RNG.normal(size=N_U - 1), 4.0 + RNG.random(N_U), RNG.normal(size=N_U - 1),
             RNG.normal(size=N_U))
BROADCAST = UNBATCHED[:3] + (RNG.normal(size=(5, N_U)),)
INDIVISIBLE = (np.ones(62), np.full(63, 4.0), np.ones(62), np.ones(63))
# explicit steps: dt = 1.25e-3 sits under the CFL bound dx^2 / sigma^2 = 4e-3
HALO_NP = dict(sigma=0.2, r=0.05, q=0.0, T=0.25, K=100.0, n_space=256, n_time=200)
HALO_SOLVER = dict(sigma=0.2, r=0.05, q=0.02, T=0.25, K=100.0, n_space=256, n_time=200)
BS_EURO = dict(n_space=200, n_time=50, is_call=False, q=0.01)
BS_AMER = dict(n_space=160, n_time=50, is_call=False, american=True)
HESTON_EURO = dict(q=0.02, n_spot=64, n_vol=30, n_time=30)
HESTON_IT = dict(is_call=False, american=True, american_method="it_lcp", r=0.08, q=0.0,
                 n_spot=64, n_vol=24, n_time=25)
SOLVES = {"bs_euro": (BS_EURO, 100.0), "bs_amer": (BS_AMER, 95.0),
          "heston_euro": (HESTON_EURO, 100.0), "heston_it": (HESTON_IT, 90.0)}
LOWER = np.array([0.1, 0.01, 0.01, -0.99, 0.01])
UPPER = np.array([10.0, 1.0, 2.0, 0.99, 1.0])
TRUE_X = np.array([2.0, 0.04, 0.3, -0.7, 0.04])
MESH_SHAPES = ((2, 2), (4, 1), (1, 4))


def _step_book(near_truth):
    """The reference tests' calibration-step books (tests/test_parallel.py:
    49-138): U = 4 surfaces of Q = 16 quotes, targets on the truth."""
    U, Q = 4, 16
    if near_truth:
        strikes = np.tile(np.linspace(85.0, 115.0, Q), (U, 1))
        maturities = np.tile(np.repeat([0.25, 0.5, 1.0, 2.0], Q // 4)[None, :], (U, 1))
        x0 = np.tile([2.2, 0.05, 0.35, -0.6, 0.05], (U, 1))
    else:
        strikes = np.tile(np.linspace(90.0, 110.0, Q), (U, 1))
        maturities = np.full((U, Q), 0.5)
        x0 = np.tile([1.5, 0.06, 0.4, -0.5, 0.06], (U, 1))
    target = np.maximum(np.asarray(jax.vmap(
        lambda x, k, t: jmesh._price_population(x, k, t, 100.0, 0.05, 0.0))(
        jnp.tile(jnp.asarray(TRUE_X), (U, 1)), jnp.asarray(strikes),
        jnp.asarray(maturities))), 1e-3)
    return strikes, maturities, target, x0, np.full(U, 1e-3)


@pytest.fixture(scope="module")
def books():
    return {"step": _step_book(False), "near": _step_book(True)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, books):
    """Every case of this module, run once on four spawned gloo ranks."""
    cases = [("distributed", W.case_distributed, ())]
    for P in SOLVE_PS:
        cases += [(f"tri_batched_{P}", W.case_tridiag, (P, *BATCHED)),
                  (f"tri_unbatched_{P}", W.case_tridiag, (P, *UNBATCHED)),
                  (f"tri_broadcast_{P}", W.case_tridiag, (P, *BROADCAST))]
        for name, (kw, s0) in SOLVES.items():
            params = (tbs.BSPDEParams if name.startswith("bs") else tadi.HestonPDEParams)(**kw)
            fn = W.case_bs_solve if name.startswith("bs") else W.case_heston_solve
            cases.append((f"{name}_{P}", fn, (P, params, s0)))
    for P in PS:
        cases += [(f"tri_indivisible_{P}", W.case_tridiag, (P, *INDIVISIBLE)),
                  (f"halo_np_{P}", W.case_halo, (P, HALO_NP)),
                  (f"halo_solver_{P}", W.case_halo, (P, HALO_SOLVER)),
                  (f"halo_indivisible_{P}", W.case_halo, (P, dict(HALO_NP, n_space=101))),
                  (f"heston_indivisible_{P}", W.case_heston_solve,
                   (P, tadi.HestonPDEParams(n_spot=63, n_vol=8, n_time=2), 100.0))]
    cases.append(("comm_audit", W.case_comm_audit, ((1,) + PS, UNBATCHED)))
    s, m, t, x0, lam = books["step"]
    cases.append(("steps", W.case_calibration_steps,
                  (MESH_SHAPES, LOWER, UPPER, x0, s, m, t, lam, 8)))
    s, m, t, x0, lam = books["near"]
    cases.append(("near", W.case_calibration_steps, (((2, 2),), LOWER, UPPER, x0, s, m, t,
                                                     lam, 25)))
    return W.run_ranks(WORLD, cases, tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two real processes for ``initialize_distributed``."""
    return W.run_ranks(2, [("distributed", W.case_distributed, ())],
                       tmp_path_factory.mktemp("pair"))


def _out(ranks, name):
    return W.same_on_every_rank(W.outputs(ranks, name))


# ------------------------------------------------------------------- mesh

def test_initialize_distributed_joins_two_processes(pair):
    out = _out(pair, "distributed")
    assert out["bare"] == 2 and out["sum"] == 3.0
    assert out["shape"] == (2, 1) and out["names"] == ("dp", "quotes")
    assert "no CUDA device" in out["card"]
    assert "3 devices asked of a world of 2 ranks" in out["wrong"]


def test_initialize_distributed_on_four_ranks(ranks):
    out = _out(ranks, "distributed")
    assert out["bare"] == 4 and out["sum"] == 10.0
    assert out["shape"] == jmesh.best_factorization(4) == (2, 2)


def test_bare_call_without_a_group_is_the_world_of_one():
    assert initialize_distributed() == 1


def test_best_factorization_is_the_reference_s():
    from pde_tpu_torch.parallel.mesh import best_factorization

    for n in (1, 2, 4, 6, 7, 8, 12, 16):
        assert best_factorization(n) == jmesh.best_factorization(n)
        for u in (1, 2, 3, 6, 8, 12, 16, 32):
            assert best_factorization(n, u) == jmesh.best_factorization(n, u)


def test_make_mesh_needs_a_group():
    from pde_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        make_mesh(device_type="tpu")


@pytest.mark.parametrize("mesh_type,device,same", [
    ("cuda", "cuda", True), ("cuda", "cuda:1", True), ("cuda", "cuda:0", False),
    ("cuda", torch.device("cuda"), True), ("cuda", "cpu", False),
    ("cpu", "cpu", True), ("cpu", torch.device("cpu"), True), ("cpu", "cuda", False)])
def test_a_device_with_no_index_is_the_mesh_s_current_one(monkeypatch, mesh_type, device,
                                                         same):
    """``HestonCalibrator(device="cuda")`` on a mesh over ``cuda:<current>``
    (here the current card is faked as 1): an index-less device matches."""
    from pde_tpu_torch.parallel.mesh import on_mesh_device

    class Mesh:
        device_type = mesh_type

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert on_mesh_device(Mesh(), device) is same


def test_calibrator_refuses_a_mesh_on_another_device():
    from pde_tpu_torch.calibrate.heston import HestonCalibrator

    class Mesh:
        device_type = "cpu"

    with pytest.raises(ValueError, match="is not the calibrator's cuda:1"):
        HestonCalibrator(device="cuda:1")._shard_batch(Mesh(), *[None] * 5)


def test_initialize_distributed_needs_all_three():
    with pytest.raises(ValueError, match="together"):
        initialize_distributed("localhost:1234")


def test_axis_name_without_a_mesh_raises():
    from pde_tpu_torch.parallel import psum

    with pytest.raises(ValueError, match="no mesh is in use"):
        psum(torch.ones(2), "paths")


# --------------------------------------------------------- partitioned Thomas

@pytest.mark.parametrize("P", SOLVE_PS)
@pytest.mark.parametrize("case", ["batched", "unbatched", "broadcast"])
def test_partitioned_thomas_matches_thomas(ranks, case, P):
    bands = {"batched": BATCHED, "unbatched": UNBATCHED, "broadcast": BROADCAST}[case]
    want = np.asarray(jtri.thomas(*(jnp.asarray(b) for b in bands)))
    np.testing.assert_allclose(_out(ranks, f"tri_{case}_{P}"), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("P", PS)
def test_partitioned_thomas_indivisible_raises(ranks, P):
    assert _out(ranks, f"tri_indivisible_{P}") == (
        f"ValueError: system length 63 not divisible by axis size {P}")


def test_interface_solve_is_the_reference_s():
    """The pivot-free elimination of the interface system, on a random
    diagonally dominant batch, against the reference's own."""
    from pde_tpu.parallel.dist_tridiag import _solve_small_nopivot as jsolve
    from pde_tpu_torch.parallel.dist_tridiag import _solve_small_nopivot

    M = RNG.normal(size=(3, 8, 8)) + 10.0 * np.eye(8)
    r = RNG.normal(size=(3, 8))
    got = _solve_small_nopivot(torch.tensor(M), torch.tensor(r), 8).numpy()
    want = jax.jit(jsolve, static_argnums=2)(jnp.asarray(M), jnp.asarray(r), 8)
    np.testing.assert_allclose(got, np.asarray(want),
                               rtol=1e-13, atol=1e-14)


# ------------------------------------------------------------- halo marches

def _explicit_march(sigma, r, q, T, K, n_space, n_time):
    """The reference test's single-device explicit march in numpy
    (tests/test_parallel.py:148-169)."""
    x = np.linspace(np.log(K * 0.2), np.log(K * 5.0), n_space)
    s = np.exp(x)
    dx = x[1] - x[0]
    dt = T / n_time
    a = 0.5 * sigma**2 / dx**2
    b = (r - q - 0.5 * sigma**2) / (2 * dx)
    Lm, Lc, Lp = a - b, -2 * a - r, a + b
    V = np.maximum(s - K, 0.0)
    for step in range(n_time):
        tau = (step + 1) * dt
        LV = np.zeros_like(V)
        LV[1:-1] = Lm * V[:-2] + Lc * V[1:-1] + Lp * V[2:]
        V = V + dt * LV
        V[0] = 0.0
        V[-1] = s[-1] * np.exp(-q * tau) - K * np.exp(-r * tau)
    return s, V


@pytest.mark.parametrize("P", PS)
def test_halo_march_matches_single_device(ranks, P):
    s_grid, V = _out(ranks, f"halo_np_{P}")
    s_ref, V_ref = _explicit_march(**HALO_NP)
    np.testing.assert_allclose(s_grid, s_ref, rtol=1e-12)
    np.testing.assert_allclose(V, V_ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("P", PS)
def test_halo_march_matches_the_explicit_solver(ranks, P):
    _, V = _out(ranks, f"halo_solver_{P}")
    res = jbs.solve(jbs.BSPDEParams(scheme="explicit", **HALO_SOLVER), 100.0)
    np.testing.assert_allclose(V, np.asarray(res.prices), rtol=1e-9, atol=1e-9)


def test_halo_march_mesh_size_invariance(ranks):
    runs = [_out(ranks, f"halo_solver_{P}")[1] for P in PS]
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-10)


@pytest.mark.parametrize("P", PS)
def test_halo_indivisible_grid_raises(ranks, P):
    assert _out(ranks, f"halo_indivisible_{P}") == (
        f"ValueError: n_space=101 not divisible by mesh size {P}")


# ----------------------------------------------------- sharded implicit marches

@pytest.mark.parametrize("P", SOLVE_PS)
@pytest.mark.parametrize("name", ["bs_euro", "bs_amer"])
def test_sharded_bs_solve_matches_single_device(ranks, name, P):
    kw, s0 = SOLVES[name]
    ref = jbs.solve(jbs.BSPDEParams(**kw), s0)
    out = _out(ranks, f"{name}_{P}")
    np.testing.assert_allclose(out["price"], float(ref.price), rtol=1e-12)
    np.testing.assert_allclose(out["prices"], np.asarray(ref.prices), rtol=1e-10, atol=1e-10)
    for g in ("delta", "gamma", "theta"):
        np.testing.assert_allclose(out[g], float(getattr(ref, g)), rtol=1e-8, atol=1e-10)


@pytest.fixture(scope="module")
def heston_refs():
    return {name: jadi.solve(jadi.HestonPDEParams(**SOLVES[name][0]), SOLVES[name][1])
            for name in ("heston_euro", "heston_it")}


@pytest.mark.parametrize("P", SOLVE_PS)
@pytest.mark.parametrize("name", ["heston_euro", "heston_it"])
def test_sharded_heston_solve_matches_single_device(ranks, heston_refs, name, P):
    ref = heston_refs[name]
    out = _out(ranks, f"{name}_{P}")
    np.testing.assert_allclose(out["price"], float(ref.price), rtol=1e-11)
    np.testing.assert_allclose(out["prices"], np.asarray(ref.prices), rtol=1e-9, atol=1e-9)
    for g in ("delta", "gamma", "vega", "theta"):
        np.testing.assert_allclose(out[g], float(getattr(ref, g)), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(out["spot_grid"], np.asarray(ref.spot_grid), rtol=1e-14)
    np.testing.assert_allclose(out["vol_grid"], np.asarray(ref.vol_grid), rtol=1e-14)


@pytest.mark.parametrize("P", PS)
def test_sharded_heston_indivisible_grid_raises(ranks, P):
    assert _out(ranks, f"heston_indivisible_{P}") == (
        f"ValueError: n_spot=63 not divisible by mesh size {P}")


def test_sharded_solves_refuse_what_the_reference_refuses():
    """The argument checks run before any collective (no group needed)."""
    from pde_tpu_torch.parallel import sharded_bs_solve, sharded_heston_solve

    class OneRank:
        mesh_dim_names = ("grid",)

        def size(self, i):
            return 1

    with pytest.raises(ValueError, match="crank_nicolson"):
        sharded_bs_solve(OneRank(), tbs.BSPDEParams(scheme="explicit"), 100.0)
    with pytest.raises(ValueError, match="projection"):
        sharded_bs_solve(OneRank(), tbs.BSPDEParams(american=True, american_method="psor"),
                         100.0)
    with pytest.raises(ValueError, match="Douglas"):
        sharded_heston_solve(OneRank(), tadi.HestonPDEParams(scheme="hv"), 100.0)
    with pytest.raises(ValueError, match="it_lcp"):
        sharded_heston_solve(OneRank(), tadi.HestonPDEParams(
            american=True, american_method="psor"), 100.0)


# ------------------------------------------------------- the calibration step

@pytest.fixture(scope="module")
def reference_steps(books):
    """The reference's step on a one-device mesh, 8 steps."""
    strikes, maturities, target, x, lam = (jnp.asarray(a) for a in books["step"])
    step = jmesh.sharded_calibration_step(jmesh.make_mesh(1, shape=(1, 1)),
                                          jnp.asarray(LOWER), jnp.asarray(UPPER))
    costs = []
    for _ in range(8):
        x, cost, lam = step(x, strikes, maturities, target, lam, 100.0, 0.05, 0.0)
        costs.append(np.asarray(cost))
    return dict(x=np.asarray(x), costs=np.stack(costs), lam=np.asarray(lam))


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_calibration_step_matches_the_reference(ranks, reference_steps, shape):
    got = _out(ranks, "steps")[shape]
    np.testing.assert_allclose(got["x"], reference_steps["x"], rtol=1e-8)
    np.testing.assert_allclose(got["costs"], reference_steps["costs"], rtol=1e-8)
    np.testing.assert_allclose(got["lam"], reference_steps["lam"], rtol=1e-12)
    assert got["costs"][-1].mean() < got["costs"][0].mean()


def test_calibration_step_same_on_every_mesh_shape(ranks):
    runs = _out(ranks, "steps")
    for shape in MESH_SHAPES[1:]:
        np.testing.assert_allclose(runs[shape]["x"], runs[MESH_SHAPES[0]]["x"], rtol=1e-10)
        np.testing.assert_allclose(runs[shape]["costs"], runs[MESH_SHAPES[0]]["costs"],
                                   rtol=1e-10)


def test_calibration_steps_converge_toward_truth(ranks):
    got = _out(ranks, "near")[(2, 2)]
    assert np.max(np.abs(got["x"][:, 4] - 0.04)) < 0.01
    assert got["costs"][-1].mean() < 1e-4


# ------------------------------------------------------ the collective audit

AUDITED = ("sharded_bs_solve", "sharded_heston_solve", "dist_tridiagonal_solve",
           "sharded_calibration_step", "price_american_lsm_sharded",
           "calibrate_leverage_sharded")
GATHERS_STATE = AUDITED[:3]
# program -> (counts a step, counts besides the steps), at every P > 1
AUDIT_COUNTS = {
    "sharded_bs_solve": ({"collective-permute": 1, "all-gather": 1}, {"all-gather": 1}),
    "sharded_heston_solve": ({"collective-permute": 1, "all-gather": 1}, {"all-gather": 1}),
    "dist_tridiagonal_solve": ({"all-gather": 1}, {}),
    "sharded_calibration_step": ({"all-reduce": 2}, {}),
    "price_american_lsm_sharded": ({"all-reduce": 5}, {"all-reduce": 1}),
    "calibrate_leverage_sharded": ({"all-reduce": 1}, {"all-reduce": 1}),
}


def _nonzero(counts):
    return {op: n for op, n in counts.items() if n}


@pytest.fixture(scope="module")
def audits(ranks):
    return W.outputs(ranks, "comm_audit")


def test_audit_covers_the_six_programs(audits):
    from pde_tpu.parallel.comm_audit import COLLECTIVE_OPS as JOPS
    from pde_tpu_torch.parallel.comm_audit import COLLECTIVE_OPS

    assert COLLECTIVE_OPS == JOPS
    for out in audits:
        assert set(out["table"]) == set(AUDITED)


@pytest.mark.parametrize("program", AUDITED)
def test_audit_counts_a_step_do_not_depend_on_p(audits, program):
    for rank, out in enumerate(audits):
        by_p = out["table"][program]
        for P in PS:
            assert (_nonzero(by_p[P]["per_step"]), _nonzero(by_p[P]["fixed"])) == \
                AUDIT_COUNTS[program], (rank, P, by_p[P])
            assert by_p[P]["per_step"]["all-to-all"] == 0
            assert by_p[P]["per_step"]["reduce-scatter"] == 0


@pytest.mark.parametrize("program", AUDITED)
def test_audit_counts_nothing_at_one_rank(audits, program):
    for out in audits:
        entry = out["table"][program][1]
        assert not _nonzero(entry["per_step"]) and not _nonzero(entry["fixed"])
        assert entry["bytes_sent"] == 0


def test_dist_solve_is_one_all_gather_and_no_permute(audits):
    for out in audits:
        assert _nonzero(out["counts"]) == {"all-gather": 1}
        assert [op for op, _ in out["calls"]] == ["all-gather"]


@pytest.mark.parametrize("program", AUDITED)
def test_audit_bytes_a_rank_sends(audits, program):
    """At a fixed problem size: a program that gathers sharded state sends
    fewer bytes a rank at P = 4 than at 2; one that reduces statistics
    sends the same."""
    for rank, out in enumerate(audits):
        by_p = out["table"][program]
        two, four = by_p[2]["bytes_sent"], by_p[4]["bytes_sent"]
        assert two > 0, (rank, program)
        if program in GATHERS_STATE:
            assert four < two, (rank, program, two, four)
        else:
            assert four == two, (rank, program, two, four)


def test_the_audit_changes_no_result(audits):
    want = np.asarray(jtri.thomas(*(jnp.asarray(b) for b in UNBATCHED)))
    for out in audits:
        assert out["restored"]
        np.testing.assert_array_equal(out["recorded"], out["bare"])
        np.testing.assert_allclose(out["bare"], want, rtol=1e-12, atol=1e-12)
