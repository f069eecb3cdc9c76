"""Communication accounting of the sharded programs (twin of
``pde_tpu/parallel/comm_audit.py``).

The reference counts the collective instructions in XLA's optimized HLO of
each sharded program.  The port has no compiled program to read: each rank
runs Python that calls ``torch.distributed``.  So the audit records what
actually runs.  While a program runs, :func:`collective_counts` wraps the
``torch.distributed`` collectives the port calls and counts each call, by
the reference's names:

* ``all_reduce`` -> ``all-reduce``; ``all_gather`` and
  ``all_gather_into_tensor`` -> ``all-gather``; ``reduce_scatter`` and
  ``reduce_scatter_tensor`` -> ``reduce-scatter``; ``all_to_all`` and
  ``all_to_all_single`` -> ``all-to-all``;
* ``batch_isend_irecv`` -> ``collective-permute``: one batch of
  point-to-point sends and receives is one permute, as ``ppermute`` is.

With each call it adds up the bytes this rank hands to the collective: the
tensor it reduces, the shard it contributes to a gather, the tensors it
sends point to point.  The wrappers pass every argument through, so the
audit does not change what a program computes.  A collective over an axis
of one rank is skipped by the port (``mesh.psum``, ``mesh.all_gather``,
the halo exchange), so at P = 1 every program counts nothing.

Counts of the port's programs (runtime calls on each rank, P >= 2; a
march's counts are per time step, found by running it at two step counts;
asserted in ``tests/test_torch_parallel.py``):

* ``sharded_bs_solve`` — a CN step: 1 ``collective-permute`` (the one-row
  halos both ways, one batch) + 1 ``all-gather`` (the partitioned Thomas
  solve's interface rows, 8 numbers a system); then 1 ``all-gather`` of
  the grid's shards.
* ``sharded_heston_solve`` — a Douglas ADI step: 1 ``collective-permute``
  (halo rows of the (m, nv) block) + 1 ``all-gather`` (the S-sweep's
  interface system, 8 numbers a variance level); the v-sweep is local.
  Then 1 ``all-gather`` of the grid.
* ``dist_tridiagonal_solve`` — 1 ``all-gather`` in all: every block's
  (g, w_L, w_R), from which each rank solves the interface system and
  back-substitutes every block.
* ``sharded_calibration_step`` — 2 ``all-reduce``s over the quotes axis
  (J^T J, J^T r and the cost: 31 numbers a surface; the trial cost).
* ``price_american_lsm_sharded`` — 5 ``all-reduce``s an exercise date
  (the n_steps - 1 dates before maturity: the in-the-money count, the
  features' means and variances, the Gram matrix, the right-hand side)
  and 1 for the price's moments.
* ``calibrate_leverage_sharded`` — 1 ``all-reduce`` a time step (the
  bins' counts and sums, ~2 n_bins + 2 numbers) and 1 for the validation
  price's moments.

Per step, the counts are the same at every P, and no program uses
``all-to-all``.  The payloads: halos and interface rows scale with the
unsharded axis only, the reductions carry a fixed number of statistics,
and the gathered grid or solution is 1/P of the whole on each rank; so at
a fixed problem size the bytes a rank sends in a call shrink as P grows
where a program gathers sharded state, and stay the same where it only
reduces statistics.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVE_OPS", "collective_counts", "audit_table"]

COLLECTIVE_OPS = (
    "collective-permute",
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
)

# torch.distributed function -> (op, the bytes this rank sends in one call)
_nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
_WRAPPED = {
    "all_reduce": ("all-reduce", lambda tensor, *a, **k: _nbytes(tensor)),
    "all_gather": ("all-gather", lambda tensor_list, tensor, *a, **k: _nbytes(tensor)),
    "all_gather_into_tensor": ("all-gather", lambda out, inp, *a, **k: _nbytes(inp)),
    "reduce_scatter": ("reduce-scatter",
                       lambda out, input_list, *a, **k: sum(map(_nbytes, input_list))),
    "reduce_scatter_tensor": ("reduce-scatter", lambda out, inp, *a, **k: _nbytes(inp)),
    "all_to_all": ("all-to-all", lambda out_list, in_list, *a, **k: sum(map(_nbytes, in_list))),
    "all_to_all_single": ("all-to-all", lambda out, inp, *a, **k: _nbytes(inp)),
    "batch_isend_irecv": ("collective-permute", lambda ops, *a, **k: sum(
        _nbytes(op.tensor) for op in ops if op.op.__name__ == "isend")),
}
_LOCK = threading.Lock()


@contextlib.contextmanager
def _recording():
    """Count the collectives called in the block: yields a list that
    receives one (op, bytes sent) pair a call."""
    if not _LOCK.acquire(blocking=False):
        raise RuntimeError("comm_audit: a recording is already running")
    calls, originals = [], {name: getattr(dist, name) for name in _WRAPPED}

    def wrap(name, fn):
        op, sent = _WRAPPED[name]

        def counted(*args, **kwargs):
            calls.append((op, int(sent(*args, **kwargs))))
            return fn(*args, **kwargs)

        return counted

    try:
        for name, fn in originals.items():
            setattr(dist, name, wrap(name, fn))
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
        _LOCK.release()


def _record(fn: Callable, *args, **kwargs) -> tuple[dict[str, int], int]:
    with _recording() as calls:
        fn(*args, **kwargs)
    counts = {op: 0 for op in COLLECTIVE_OPS}
    for op, _ in calls:
        counts[op] += 1
    return counts, sum(b for _, b in calls)


def collective_counts(fn: Callable, *args, **kwargs) -> dict[str, int]:
    """Run ``fn(*args, **kwargs)`` on this rank and count the collectives
    it calls, by kind (every kind of :data:`COLLECTIVE_OPS`, zeros
    included).  Every rank of the group must run it, as the program's
    collectives need."""
    return _record(fn, *args, **kwargs)[0]


def _mesh(k: int, names, device_type, shape=None):
    """A mesh whose last named dimension has ``k`` ranks (the others one
    each, ``shape`` gives them), and a ``rep`` dimension holding the world's
    remaining ranks, each column of which runs the same program."""
    from .mesh import make_mesh

    world = dist.get_world_size()
    if world % k:
        raise ValueError(f"audit_table: mesh size {k} does not divide the world of {world}")
    shape = tuple(shape or (k,))
    if world == k:
        return make_mesh(shape=shape, axis_names=names, device_type=device_type)
    return make_mesh(shape=shape + (world // k,), axis_names=tuple(names) + ("rep",),
                     device_type=device_type)


def _per_step(run, units=lambda n: n, steps=(2, 3)) -> dict:
    """A march's counts a step, and what it issues besides, from two runs
    ``run(n)`` of n time steps each; ``units(n)`` is the number of steps
    that issue collectives in a run of n (an LSM's exercise dates are
    n - 1)."""
    (c1, b1), (c2, b2) = (run(n) for n in steps)
    u1, u2 = units(steps[0]), units(steps[1])
    per_step = {op: (c2[op] - c1[op]) // (u2 - u1) for op in COLLECTIVE_OPS}
    return {"steps": steps[0], "per_step": per_step,
            "fixed": {op: c1[op] - u1 * per_step[op] for op in COLLECTIVE_OPS},
            "bytes_per_step": (b2 - b1) // (u2 - u1), "bytes_sent": b1}


def _one_shot(counts_bytes) -> dict:
    counts, nbytes = counts_bytes
    return {"steps": None, "per_step": counts, "fixed": {op: 0 for op in COLLECTIVE_OPS},
            "bytes_per_step": nbytes, "bytes_sent": nbytes}


def audit_table(mesh_sizes=None, *, device_type: str | None = None) -> dict:
    """The collectives of every sharded program at each mesh size.

    Call it on every rank of a process group; ``mesh_sizes`` (default: the
    world size) must divide the world.  At size k the programs run on a
    mesh whose sharded axis has k ranks, and every further group of k
    ranks runs them too.  The problem sizes are fixed, the same at every k.
    ``device_type`` is the meshes' (the card by default; ``"cpu"`` on a
    gloo group).  Returns ``{program: {k: entry}}``, with ``entry`` holding
    ``per_step`` (a march's counts a time step, or a one-shot program's
    counts), ``fixed`` (a march's collectives outside its steps), ``steps``
    (the steps of the run whose bytes are given; ``None`` for a one-shot
    program), ``bytes_sent`` (what this rank sent in that run) and
    ``bytes_per_step``.
    """
    from ..models.heston import HestonParams
    from ..solvers.bs_pde import BSPDEParams
    from ..solvers.heston_adi import HestonPDEParams
    from .adi_sharded import sharded_bs_solve, sharded_heston_solve
    from .dist_tridiag import dist_tridiagonal_solve
    from .mc import calibrate_leverage_sharded, price_american_lsm_sharded
    from .mesh import mesh_device, sharded_calibration_step

    if mesh_sizes is None:
        mesh_sizes = (dist.get_world_size(),)
    heston = HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
    out: dict[str, dict[int, dict]] = {}
    for k in mesh_sizes:
        gm = _mesh(k, ("grid",), device_type)
        dm = _mesh(k, ("dp",), device_type)
        cm = _mesh(k, ("dp", "quotes"), device_type, shape=(1, k))
        dev = mesh_device(gm)
        f32 = dict(dtype=torch.float32, device=dev)

        out.setdefault("sharded_bs_solve", {})[k] = _per_step(lambda n: _record(
            sharded_bs_solve, gm, BSPDEParams(K=100.0, T=0.5, sigma=0.2, r=0.05, n_space=64,
                                              n_time=n), 100.0))
        out.setdefault("sharded_heston_solve", {})[k] = _per_step(lambda n: _record(
            sharded_heston_solve, gm, HestonPDEParams(n_spot=32, n_vol=8, n_time=n), 100.0))

        n = 64
        out.setdefault("dist_tridiagonal_solve", {})[k] = _one_shot(_record(
            dist_tridiagonal_solve, torch.full((n - 1,), -1.0, **f32),
            torch.full((n,), 4.0, **f32), torch.full((n - 1,), -1.0, **f32),
            torch.arange(n, **f32), gm))

        step = sharded_calibration_step(cm, torch.tensor([0.1, 0.01, 0.01, -0.99, 0.01]),
                                        torch.tensor([10.0, 1.0, 2.0, 0.99, 1.0]))
        U, Q = 1, 16
        out.setdefault("sharded_calibration_step", {})[k] = _one_shot(_record(
            step, torch.tensor([[1.0, 0.09, 0.5, -0.2, 0.09]] * U),
            torch.linspace(90.0, 110.0, Q).repeat(U, 1), torch.full((U, Q), 0.5),
            torch.full((U, Q), 5.0), torch.full((U,), 1e-3), 100.0, 0.05, 0.0))

        out.setdefault("price_american_lsm_sharded", {})[k] = _per_step(lambda n: _record(
            price_american_lsm_sharded, heston, 100.0, 0.5, 100.0, 0, dm, rate=0.05,
            n_steps=n, n_paths=512), units=lambda n: n - 1)
        out.setdefault("calibrate_leverage_sharded", {})[k] = _per_step(lambda n: _record(
            calibrate_leverage_sharded, heston, lambda s, t: torch.full_like(s, 0.2), 100.0,
            0.5, 1, dm, rate=0.05, n_steps=n, n_paths=512, n_bins=9))
    return out


def main():  # pragma: no cover - command-line entry
    """Print the audit at world size 1 on the card: one rank of an NCCL
    group on a file store (at one rank every collective is skipped, so
    every count is 0; run :func:`audit_table` on the ranks of a larger
    group for the counts at P > 1)."""
    import os
    import tempfile

    from .mesh import initialize_distributed

    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{os.path.join(tmp, 'store')}", 1, 0)
        try:
            table = audit_table()
        finally:
            dist.destroy_process_group()
    for prog, by_k in table.items():
        print(f"\n{prog}")
        for k, entry in sorted(by_k.items()):
            nz = {op: c for op, c in entry["per_step"].items() if c}
            print(f"  mesh={k}: {nz or '(no collectives)'} a step, "
                  f"{entry['bytes_sent']} bytes sent")


if __name__ == "__main__":  # pragma: no cover
    main()
