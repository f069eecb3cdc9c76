"""Runs the port's multi-rank cases on P spawned CPU ranks of one gloo
group (test-side helper; it imports torch and the port, never JAX, so the
ranks start quickly).

``run_ranks(world, cases, tmp_dir)`` spawns ``world`` processes
(``torch.multiprocessing``'s ``spawn`` context) that join a group through
the port's own ``parallel.initialize_distributed`` on a file store in
``tmp_dir`` (no port, no collision between test workers), with a 60 s
collective timeout.  Every rank runs every case in order, ``fn(*args)``,
and sends back what it returns.  A case that raises ends its rank, so the
other ranks fail at their next collective and the run ends; the parent
kills what is left at the deadline.  The result maps each case name to its
per-rank outputs, or to the error that stopped it: one case fails, the
suite does not hang.

The case functions below are module-level, so that a spawned rank can
import them by name.
"""

from __future__ import annotations

import os
import queue
import time
import traceback
from datetime import timedelta

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 60.0


def _rank_main(rank, world, store, cases, out):
    torch.set_num_threads(1)  # P ranks share the test worker's cores
    from pde_tpu_torch.parallel import initialize_distributed

    import torch.distributed as dist

    n = initialize_distributed(f"file://{store}", world, rank, device="cpu",
                               timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    assert n == world, (n, world)
    try:
        for name, fn, args in cases:
            try:
                value = fn(*args)
            except BaseException:  # noqa: BLE001 - reported to the parent, then the rank ends
                out.put((rank, name, "error", traceback.format_exc()))
                out.close()
                out.join_thread()
                os._exit(1)
            out.put((rank, name, "ok", value))
    finally:
        dist.destroy_process_group()
    out.put((rank, None, "done", None))


def run_ranks(world, cases, tmp_dir, deadline_s=240.0):
    """``{name: [rank 0's output, ...]}`` for every case that all ranks
    finished, and ``{name: error}`` for those that did not."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_dir), f"store_{world}")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, cases, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {name: [None] * world for name, _, _ in cases}
    errors, finished = {}, set()
    end = time.monotonic() + deadline_s
    while len(finished) < world and time.monotonic() < end:
        try:
            rank, name, status, value = out.get(timeout=0.5)
        except queue.Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                # a rank died: the rest end at their next collective
                end = min(end, time.monotonic() + COLLECTIVE_TIMEOUT_S + 10.0)
            if all(p.exitcode is not None for p in procs):
                break
            continue
        if status == "done":
            finished.add(rank)
        elif status == "ok":
            results[name][rank] = value
        else:
            errors.setdefault(name, f"rank {rank}:\n{value}")
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    for name, per_rank in results.items():
        if name not in errors and any(v is None for v in per_rank):
            errors[name] = "a rank did not finish this case (killed at the deadline or " \
                           "after another case failed)"
    return {k: v for k, v in results.items() if k not in errors}, errors


def outputs(run, name):
    """The per-rank outputs of case ``name``; a case that failed fails the
    test that reads it, with the rank's traceback."""
    import pytest

    results, errors = run
    if name in errors:
        pytest.fail(f"case {name} failed on the ranks:\n{errors[name]}")
    return results[name]


def same_on_every_rank(per_rank):
    """The global-out contract: every rank returns the same result; rank
    0's is returned."""
    first = per_rank[0]
    for other in per_rank[1:]:
        for a, b in zip(_leaves(first), _leaves(other)):
            np.testing.assert_array_equal(a, b)
    return first


def _leaves(x):
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [np.asarray(x)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x) if not hasattr(x, "_fields") else \
            {k: _np(v) for k, v in zip(x._fields, x)}
    return x


# ------------------------------------------------------------------- cases


def axis_mesh(P, axis="grid"):
    """A mesh whose first dimension ``axis`` has P ranks: the whole world
    when P is its size, else a (P, world / P) mesh whose ``rep`` columns
    each run the same case on their own P ranks."""
    from pde_tpu_torch.parallel import make_mesh

    world = torch.distributed.get_world_size()
    if P == world:
        return make_mesh(shape=(P,), axis_names=(axis,), device_type="cpu")
    return make_mesh(shape=(P, world // P), axis_names=(axis, "rep"), device_type="cpu")


def case_distributed():
    """The group as the port's entry points see it."""
    import torch.distributed as dist

    from pde_tpu_torch.parallel import initialize_distributed, make_mesh

    world = dist.get_world_size()
    mesh = make_mesh(device_type="cpu")
    try:
        make_mesh()  # the card by default: no card here
        card = "built"
    except RuntimeError as exc:
        card = str(exc)
    try:
        make_mesh(world + 1, device_type="cpu")
        wrong = "built"
    except ValueError as exc:
        wrong = str(exc)
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    return dict(bare=initialize_distributed(), shape=tuple(mesh.shape),
                names=mesh.mesh_dim_names, sum=float(x), card=card, wrong=wrong)


def _value_error(fn):
    try:
        return fn()
    except ValueError as exc:
        return f"ValueError: {exc}"


def case_tridiag(P, lower, diag, upper, rhs):
    from pde_tpu_torch.parallel import dist_tridiagonal_solve

    mesh = axis_mesh(P)
    return _value_error(lambda: _np(dist_tridiagonal_solve(lower, diag, upper, rhs, mesh)))


def case_halo(P, kw):
    from pde_tpu_torch.parallel.halo import sharded_bs_explicit

    mesh = axis_mesh(P)
    return _value_error(lambda: _np(sharded_bs_explicit(mesh, dtype=torch.float64, **kw)))


def case_bs_solve(P, params, S0):
    from pde_tpu_torch.parallel import sharded_bs_solve

    mesh = axis_mesh(P)
    return _value_error(lambda: _np(sharded_bs_solve(mesh, params, S0, dtype=torch.float64)))


def case_heston_solve(P, params, S0):
    from pde_tpu_torch.parallel import sharded_heston_solve

    mesh = axis_mesh(P)
    return _value_error(lambda: _np(sharded_heston_solve(mesh, params, S0,
                                                         dtype=torch.float64)))


def case_calibration_steps(shapes, lower, upper, x0, strikes, maturities, target, lam, n_steps):
    """``n_steps`` LM steps on each (dp, quotes) mesh shape; the iterates
    and costs."""
    from pde_tpu_torch.parallel import make_mesh, sharded_calibration_step

    out = {}
    for shape in shapes:
        step = sharded_calibration_step(make_mesh(shape=shape, device_type="cpu"), lower, upper)
        x, l_ = torch.as_tensor(x0), torch.as_tensor(lam)
        costs = []
        for _ in range(n_steps):
            x, cost, l_ = step(x, strikes, maturities, target, l_, 100.0, 0.05, 0.0)
            costs.append(_np(cost))
        out[shape] = dict(x=_np(x), costs=np.stack(costs), lam=_np(l_))
    return out


def case_calibrate_batch(shape, budget, strikes, maturities, prices, S0):
    from pde_tpu_torch.calibrate.heston import HestonCalibrator
    from pde_tpu_torch.parallel import make_mesh

    cal = HestonCalibrator(device="cpu", dtype=torch.float64, **budget)
    mesh = make_mesh(shape=shape, device_type="cpu")
    out = cal.calibrate_batch(strikes, maturities, prices, S0, 0.05, 0.02, mesh=mesh)
    return {k: _np(v) for k, v in out.items()}


def case_mc(P, name, args, kwargs):
    """One sharded pricer of ``parallel.mc`` on P ranks of a mesh axis
    named ``paths``; a ValueError or TypeError is returned as its message."""
    from pde_tpu_torch.parallel import mc

    mesh = axis_mesh(P, "paths")
    try:
        out = getattr(mc, name)(*args, mesh, **kwargs)
    except (ValueError, TypeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    if name == "calibrate_leverage_sharded":
        lev, price, se = out
        return dict(values=_np(lev.values), centers=_np(lev.ln_s_centers),
                    times=_np(lev.times), price=_np(price), se=_np(se))
    return _np(out)


def case_lsm_induction(P, s_path, v_path, strike, sign, disc):
    """``lsm_backward_induction`` on this rank's block of paths with
    ``axis_name``; the cashflows of the P ranks, gathered, and the policy."""
    from pde_tpu_torch.parallel import using_mesh
    from pde_tpu_torch.parallel.mesh import all_gather, axis_index
    from pde_tpu_torch.solvers import lsm

    mesh = axis_mesh(P, "paths")
    m = s_path.shape[1] // P
    cols = slice(axis_index(mesh, "paths") * m, (axis_index(mesh, "paths") + 1) * m)
    with using_mesh(mesh):
        cash, (gamma, c) = lsm.lsm_backward_induction(
            s_path[:, cols], v_path[:, cols], strike, sign, disc, axis_name="paths",
            collect_policy=True)
    return dict(cash=_np(all_gather(cash, mesh, "paths")), gamma=_np(gamma), c=_np(c))


def case_bin_expectation(P, ln_s, v, edges, n_bins, min_count):
    """``slv._bin_expectation`` on this rank's block of particles with
    ``axis_name``; E[v | S] and the P ranks' bin indices, gathered."""
    from pde_tpu_torch.models import slv
    from pde_tpu_torch.parallel import using_mesh
    from pde_tpu_torch.parallel.mesh import all_gather, axis_index

    mesh = axis_mesh(P, "paths")
    m = ln_s.shape[0] // P
    rows = slice(axis_index(mesh, "paths") * m, (axis_index(mesh, "paths") + 1) * m)
    with using_mesh(mesh):
        ev, idx = slv._bin_expectation(ln_s[rows], v[rows], edges, n_bins, min_count=min_count,
                                       axis_name="paths")
    return dict(ev=_np(ev), idx=_np(all_gather(idx, mesh, "paths")))


def skew_vol(s, t):
    """A target local vol for the SLV cases (module-level, so it pickles)."""
    return 0.18 + 0.05 * (s / 100.0 - 1.0) ** 2 + 0.0 * t


def case_comm_audit(sizes, bands):
    """``comm_audit.audit_table`` at each mesh size, and one
    ``dist_tridiagonal_solve`` run bare and under the audit's recording
    (which must pass every argument through)."""
    import torch.distributed as dist

    from pde_tpu_torch.parallel import comm_audit, dist_tridiagonal_solve

    table = comm_audit.audit_table(sizes, device_type="cpu")
    mesh = axis_mesh(max(sizes))
    bare = _np(dist_tridiagonal_solve(*bands, mesh))
    original = dist.all_gather
    with comm_audit._recording() as calls:
        recorded = _np(dist_tridiagonal_solve(*bands, mesh))
    counts = comm_audit.collective_counts(dist_tridiagonal_solve, *bands, mesh)
    return dict(table=table, bare=bare, recorded=recorded, calls=list(calls), counts=counts,
                restored=dist.all_gather is original)
