"""The port's HJB optimal-stopping solver held against ``pde_tpu``.

Both packages march the same parameters in float64 (the JAX side under
``jax_enable_x64`` with ``backend="device"``, its own march; the port on
the CPU).  Gates, each with its reason:
- ``solve`` and ``solve_all_boundaries``, every obstacle method and
  stopping problem on a 40x16 grid: 1e-10 on V and the boundaries; the same
  factorisations, sweeps and projections in the same order;
- ``reference_compat``: the reference engine's golden values at 1e-12, as
  tests/test_golden_pde.py:123-143 holds the JAX package;
- ``boundaries_batch`` / ``extract_boundaries_batch`` for B = 3 configs:
  1e-10;
- the card's branch (one K5 solve a step on a (rows, n) batch) forced
  onto the kernel's CPU twin in float32, against the plain Thomas march in
  float32: 2e-6 relative + 1e-6 absolute;
- float32 PSOR on a stiff wide grid: no farther from float64 than the
  reference's own float32 march on the same payoffs;
- ``backend="native"``: the C++ host twin's marches (``src/cpp``, built by
  the port's own loader, never the reference's) against the reference's
  float64 march and the port's at 1e-10 relative, 1e-12 absolute; the
  threaded Brennan-Schwartz call bit for bit the single marches; the
  routed boundaries equal the device route's; a missing compiler raises.
The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.solvers import hjb as jhjb
from pde_tpu_torch import interop, native
from pde_tpu_torch.native import loader as native_loader
from pde_tpu_torch.ops import tridiag
from pde_tpu_torch.solvers import hjb as thjb

with open(os.path.join(os.path.dirname(__file__), "golden",
                       "reference_pde_values.json")) as fh:
    GOLD = json.load(fh)

GATE = dict(rtol=1e-10, atol=1e-10)
METHODS = ("projection", "psor", "brennan_schwartz")
SMALL = dict(n_space=40, n_time=16, c_entry=0.002, c_exit=0.002, backend="device")
CPU64 = dict(device="cpu", dtype=torch.float64)


def _same_boundary(got, want):
    if want is None:
        assert got is None
    else:
        np.testing.assert_allclose(got, want, **GATE)


@pytest.mark.parametrize("problem", list(jhjb.StoppingProblem), ids=lambda p: p.name)
@pytest.mark.parametrize("method", METHODS)
def test_solve_matches_reference(method, problem):
    p = jhjb.HJBParams(method=method, problem=problem, **SMALL)
    want = jhjb.solve(p)
    got = thjb.solve(interop.hjb_params(p), **CPU64)
    np.testing.assert_allclose(got.value_function, want.value_function, **GATE)
    np.testing.assert_array_equal(got.x_grid, want.x_grid)
    _same_boundary(got.lower_boundary, want.lower_boundary)
    _same_boundary(got.upper_boundary, want.upper_boundary)
    assert got.stop_loss is None
    assert got.should_stop(-0.5) == want.should_stop(-0.5)
    np.testing.assert_allclose(got.value_at(0.1), want.value_at(0.1), **GATE)


@pytest.mark.parametrize("method", METHODS)
def test_solve_all_boundaries_matches_reference(method):
    p = jhjb.HJBParams(method=method, theta=0.05, mu=3.0, sigma=0.15, **SMALL)
    want = jhjb.solve_all_boundaries(p)
    got = thjb.solve_all_boundaries(interop.hjb_params(p), **CPU64)
    np.testing.assert_allclose(np.array(got), np.array(want), **GATE)


def test_reference_compat_goldens():
    """The reference engine's values (tests/test_golden_pde.py:123-143)."""
    b = thjb.solve_all_boundaries(thjb.HJBParams(reference_compat=True), **CPU64)
    for field, key in [("entry_long", "hjb_entry_long"), ("entry_short", "hjb_entry_short"),
                       ("exit_long", "hjb_exit_long"), ("exit_short", "hjb_exit_short"),
                       ("stop_loss_long", "hjb_stop_loss_long"),
                       ("stop_loss_short", "hjb_stop_loss_short")]:
        assert getattr(b, field) == pytest.approx(GOLD[key], abs=1e-12), field
    res = thjb.solve(thjb.HJBParams(reference_compat=True), **CPU64)
    assert res.value_at(0.0) == pytest.approx(GOLD["hjb_entry_long_value_at_0"], abs=1e-12)
    assert res.value_at(-0.2) == pytest.approx(GOLD["hjb_entry_long_value_at_m02"], abs=1e-12)
    b2 = thjb.solve_all_boundaries(thjb.HJBParams(
        mu=2.0, sigma=0.15, c_entry=0.005, c_exit=0.005, reference_compat=True), **CPU64)
    assert b2.entry_long == pytest.approx(GOLD["hjb2_entry_long"], abs=1e-12)
    assert b2.entry_short == pytest.approx(GOLD["hjb2_entry_short"], abs=1e-12)
    # without compat the full band is kept: the boundaries move by at most
    # one cell (tests/test_golden_pde.py:145-152)
    p = thjb.HJBParams()
    dx = (p.x_max - p.x_min) / (p.n_space - 1)
    off = thjb.solve_all_boundaries(p, **CPU64)
    assert abs(off.entry_long - GOLD["hjb_entry_long"]) <= dx + 1e-12
    assert abs(off.entry_short - GOLD["hjb_entry_short"]) <= dx + 1e-12


def _book(B=3):
    return dict(theta=np.array([0.0, 0.1, -0.05])[:B], mu=np.linspace(2.0, 8.0, B),
                sigma=np.linspace(0.05, 0.2, B), r=0.05, c_entry=0.002, c_exit=0.002,
                T=1.0, n_space=48, n_time=12)


@pytest.mark.parametrize("method", METHODS)
def test_boundaries_batch_matches_reference(method):
    kw = _book()
    want = jhjb.boundaries_batch(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                    for k, v in kw.items()}, method=method)
    got = thjb.boundaries_batch(**kw, method=method, **CPU64)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GATE)
    args = (kw["mu"], kw["sigma"], kw["theta"])
    want_b = jhjb.extract_boundaries_batch(*want, *args)
    got_b = thjb.extract_boundaries_batch(*got, *args)
    np.testing.assert_allclose(np.array(got_b), np.array(want_b), **GATE)


@pytest.mark.parametrize("entry", ["solve", "solve_all_boundaries", "boundaries_batch"])
def test_kernel_branch_on_the_cpu_twin(monkeypatch, entry):
    """The card's projection branch (each step one batched Thomas solve of
    the problems' rows, bands shared or per config) forced onto the
    kernel's CPU twin in float32 holds the plain Thomas march; the twin's
    route launches nothing."""
    p = thjb.HJBParams(n_space=40, n_time=16)
    f32 = dict(device="cpu", dtype=torch.float32)
    run = {"solve": lambda: thjb.solve(p, **f32).value_function,
           "solve_all_boundaries": lambda: np.array(thjb.solve_all_boundaries(p, **f32)),
           "boundaries_batch": lambda: thjb.boundaries_batch(
               **_book(), method="projection", **f32)[1].numpy()}[entry]
    want = run()
    monkeypatch.setattr(thjb, "kernel_route", lambda *ts: True)
    calls = []
    real = tridiag.thomas_batched

    def spy(*args):
        calls.append(args[3].shape)
        return real(*args)

    monkeypatch.setattr(tridiag, "thomas_batched", spy)
    before = real.launches
    got = run()
    rows = {"solve": 1, "solve_all_boundaries": 4, "boundaries_batch": 12}[entry]
    n_time = _book()["n_time"] if entry == "boundaries_batch" else p.n_time
    assert len(calls) == n_time and set(calls) == {(rows, calls[0][1])}
    assert real.launches == before
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


WIDE = dict(mu=7.25, sigma=0.18125, c_entry=0.002, c_exit=0.002, n_space=256, n_time=128,
            x_min=-1.0645, x_max=1.0645)


@pytest.mark.parametrize("config,methods", [
    (dict(n_time=50), METHODS),
    (dict(mu=2.0, sigma=0.15, c_entry=0.005, c_exit=0.005, n_time=50), METHODS),
    # PSOR is left out here: its 60 sweeps a step are far from converged on
    # this stiff grid (residual ~5e-4 on values ~2e-3, float64 too), and in
    # float32 the unconverged far rows drift until entry_long jumps from
    # -1.056 to +1.056 (ROADMAP C, open; the reference's float32 march drifts
    # as far: test_float32_psor_drift_is_the_reference_s)
    (WIDE, ("projection", "brennan_schwartz")),
], ids=["default", "leung_li", "wide_grid"])
def test_float32_boundaries_match_float64(config, methods):
    """The card's precision: a float32 march's boundaries against the
    float64 march's within 0.05 of a cell.  (Read with the reference's
    float64 zero, 1e-10, a float32 march's end rows put a crossing at the
    grid's edge where the float64 march has none.)"""
    p = thjb.HJBParams(**config)
    dx = (p.x_max - p.x_min) / (p.n_space - 1)
    for method in methods:
        q = p._replace(method=method)
        want = thjb.solve_all_boundaries(q, **CPU64)
        got = thjb.solve_all_boundaries(q, device="cpu", dtype=torch.float32)
        np.testing.assert_allclose(np.array(got), np.array(want), rtol=0, atol=0.05 * dx)


def test_float32_psor_drift_is_the_reference_s():
    """The stiff wide grid's float32 PSOR march (60 sweeps a step, far from
    converged) drifts from float64 in the reference as in the port
    (ROADMAP C): on the same float32 payoffs the port's worst distance from
    the float64 march is no larger than the reference's.  By
    Brennan-Schwartz (exact) both stay within float32 roundoff, 1e-5."""
    p = thjb.HJBParams(**WIDE)
    _, g = thjb._host_grid_and_payoffs(p, list(thjb.StoppingProblem))
    rev = [thjb._BS_REVERSE[pr] for pr in thjb.StoppingProblem]
    args = (p.theta, p.mu, p.sigma, p.r, p.T, p.x_min, p.x_max, p.n_space, p.n_time)
    for method, gate in (("brennan_schwartz", 1e-5), ("psor", None)):
        want = thjb._march(torch.as_tensor(g), *args, method=method, bs_reverse=rev)[1]
        port = thjb._march(torch.as_tensor(g, dtype=torch.float32), *args, method=method,
                           bs_reverse=rev)[1]
        with jax.enable_x64(False):
            ref = np.asarray(jhjb._march(g.astype(np.float32), *args, method=method,
                                         bs_reverse=np.asarray(rev))[1])
        assert ref.dtype == np.float32
        port_err = float(np.abs(port.numpy() - want.numpy()).max())
        ref_err = float(np.abs(ref - want.numpy()).max())
        assert port_err <= (gate or ref_err), (method, port_err, ref_err)
        if gate:
            assert ref_err <= gate, (method, ref_err)


def test_find_boundaries_zero_is_dtype_aware():
    """An end row one float32 ulp above g, V = g elsewhere: no crossing in
    float32; in float64 the reference's 1e-10 still decides."""
    x = np.linspace(-0.5, 0.5, 11)
    g = (x - 0.005).astype(np.float32)
    V = g.copy()
    V[-1] = np.nextafter(g[-1], np.float32(1.0))
    assert thjb._find_boundaries(V, x, g) == (None, None)
    V64, g64 = V.astype(np.float64), g.astype(np.float64)
    assert thjb._find_boundaries(V64, x, g64)[1] is not None
    V64[-1] = g64[-1] + 1e-11
    assert thjb._find_boundaries(V64, x, g64) == (None, None)


def test_backends():
    """``auto`` marches on the device it is given, as ``device`` does;
    ``native`` runs the projection and Brennan-Schwartz marches on the C++
    host twin (float64) with the same boundaries, and sends PSOR and the
    reference's own band to the device."""
    p = thjb.HJBParams(n_space=24, n_time=6)
    auto = thjb.solve_all_boundaries(p, **CPU64)
    assert auto == thjb.solve_all_boundaries(p._replace(backend="device"), **CPU64)
    for method in ("projection", "brennan_schwartz"):
        q = p._replace(method=method)
        host = thjb.solve_all_boundaries(q._replace(backend="native"))
        np.testing.assert_allclose(host, thjb.solve_all_boundaries(q, **CPU64), **GATE)
        one = thjb.solve(q._replace(backend="native", problem=thjb.StoppingProblem.EXIT_LONG))
        assert one.value_function.dtype == np.float64
        assert thjb.solve_all_boundaries(q._replace(backend="native"), **CPU64) == host
        for where in (dict(device="cuda"), dict(dtype=torch.float32)):
            with pytest.raises(ValueError, match="host in float64"):
                thjb.solve_all_boundaries(q._replace(backend="native"), **where)
    for q in (p._replace(method="psor"), p._replace(reference_compat=True)):
        assert (thjb.solve_all_boundaries(q._replace(backend="native"), **CPU64)
                == thjb.solve_all_boundaries(q, **CPU64))
    with pytest.raises(ValueError):
        thjb.solve(p._replace(mu=0.0), **CPU64)


NATIVE = dict(theta=0.0, mu=5.0, sigma=0.1, r=0.05, c_entry=0.002, c_exit=0.002, T=1.0,
              n_space=64, n_time=32)
NATIVE_GATE = dict(rtol=1e-10, atol=1e-12)


def _native_args(p):
    return (p.theta, p.mu, p.sigma, p.r, p.T, p.x_min, p.x_max)


@pytest.mark.parametrize("method", ["projection", "brennan_schwartz"])
def test_native_marches_match_reference(method):
    """The host twin's marches against the reference's device march
    (``solve(backend="device")`` and ``_march``, x64) and the port's own
    float64 march, every stopping problem."""
    for pr in jhjb.StoppingProblem:
        p = jhjb.HJBParams(method=method, problem=pr, backend="device", **NATIVE)
        want = jhjb.solve(p)
        g = np.asarray(jhjb._host_grid_and_payoffs(p, [pr])[1][0])
        rev = jhjb._BS_REVERSE[pr]
        if method == "projection":
            got = native.hjb_march(*_native_args(p), g, n_time=p.n_time)
        else:
            got = native.hjb_march_bs(*_native_args(p), g, rev, n_time=p.n_time)
        np.testing.assert_allclose(got, want.value_function, **NATIVE_GATE)
        ref_march = np.asarray(jhjb._march(g, *_native_args(p), p.n_space, p.n_time,
                                           method=method, bs_reverse=np.asarray(rev))[1])
        np.testing.assert_allclose(got, ref_march, **NATIVE_GATE)
        port = thjb._march(torch.as_tensor(g), *_native_args(p), p.n_space, p.n_time,
                           method=method, bs_reverse=rev)[1]
        np.testing.assert_allclose(got, port.numpy(), **NATIVE_GATE)


def test_native_multi_is_the_single_marches():
    p = jhjb.HJBParams(method="brennan_schwartz", **NATIVE)
    g = np.asarray(jhjb._host_grid_and_payoffs(p, list(jhjb.StoppingProblem))[1])
    rev = [jhjb._BS_REVERSE[pr] for pr in jhjb.StoppingProblem]
    multi = native.hjb_march_bs_multi(*_native_args(p), g, rev, n_time=p.n_time)
    single = np.stack([native.hjb_march_bs(*_native_args(p), gi, ri, n_time=p.n_time)
                       for gi, ri in zip(g, rev)])
    np.testing.assert_array_equal(multi, single)


@pytest.mark.parametrize("method", ["projection", "brennan_schwartz"])
def test_native_backend_boundaries_are_the_device_routes(method):
    p = jhjb.HJBParams(method=method, backend="device", **NATIVE)
    tp = interop.hjb_params(p)
    host = thjb.solve_all_boundaries(tp._replace(backend="native"))
    np.testing.assert_allclose(host, thjb.solve_all_boundaries(tp, **CPU64), **NATIVE_GATE)
    np.testing.assert_allclose(host, jhjb.solve_all_boundaries(p), **NATIVE_GATE)
    for pr in thjb.StoppingProblem:
        one = thjb.solve(tp._replace(backend="native", problem=pr))
        dev = thjb.solve(tp._replace(problem=pr), **CPU64)
        np.testing.assert_allclose(one.value_function, dev.value_function, **NATIVE_GATE)
        for a, b in ((one.lower_boundary, dev.lower_boundary),
                     (one.upper_boundary, dev.upper_boundary)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, **NATIVE_GATE)


def test_native_backend_needs_no_card(no_card):
    res = thjb.solve(thjb.HJBParams(n_space=24, n_time=6, backend="native"))
    assert np.isfinite(res.value_function).all()


@pytest.fixture()
def fresh_native(monkeypatch, tmp_path):
    """An empty build directory and no library loaded, restored after."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    native_loader.load.cache_clear()
    yield
    native_loader.load.cache_clear()


def test_native_without_a_compiler_raises(fresh_native, monkeypatch):
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    p = thjb.HJBParams(n_space=24, n_time=6, backend="native")
    for call in (thjb.solve, thjb.solve_all_boundaries):
        with pytest.raises(native.NativeUnavailable, match="g\\+\\+ not found"):
            call(p)


def test_native_build_writes_through_a_temporary_file(fresh_native, tmp_path):
    path = native_loader.build()
    assert path.parent == tmp_path and path.name.startswith("libpde_host-")
    assert [f.name for f in tmp_path.iterdir()] == [path.name]
    assert native_loader.build() == path   # built once, then found


def test_native_library_is_keyed_on_the_host_cpu(fresh_native, monkeypatch):
    """A tree copied to another CPU builds its own library: the name hashes
    what -march=native resolves to, beside the sources and flags."""
    here = native_loader.library_path()
    assert native_loader.library_path() == here
    monkeypatch.setattr(native_loader, "_target", lambda gxx: b"another cpu")
    assert native_loader.library_path() != here


def test_interop_hjb_params():
    jp = jhjb.HJBParams(problem=jhjb.StoppingProblem.EXIT_SHORT, method="psor", mu=3.0)
    tp = interop.hjb_params(jp)
    assert tp.problem is thjb.StoppingProblem.EXIT_SHORT
    assert tp._replace(problem=int(tp.problem)) == jp._replace(problem=int(jp.problem))


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda: thjb.solve(thjb.HJBParams(n_space=12, n_time=2)),
    lambda: thjb.solve_all_boundaries(thjb.HJBParams(n_space=12, n_time=2)),
    lambda: thjb.boundaries_batch(0.0, 5.0, 0.1, 0.05, 0.001, 0.001, 1.0, n_space=12,
                                  n_time=2),
], ids=["solve", "solve_all_boundaries", "boundaries_batch"])
def test_default_device_needs_the_card(no_card, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
