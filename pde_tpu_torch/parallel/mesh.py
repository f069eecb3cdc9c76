"""Device mesh and the sharded calibration step on ``torch.distributed``
(twin of ``pde_tpu/parallel/mesh.py``).

The reference runs one JAX program over a ``jax.sharding.Mesh`` and lets
XLA insert the all-reduces.  The port runs one process a device (a rank),
joined in a ``torch.distributed`` process group, and lays the ranks out as
a ``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names``
are the reference's axis names:

* ``dp`` — data parallel over underlyings/surfaces (each calibration is
  independent, no collective);
* ``quotes`` — parallel over the quote axis within one surface; the
  residual reductions (J^T J, J^T r, cost sums) are ``all_reduce``s over
  this dimension's process group;
* ``grid`` — the spot axis of a PDE grid (:mod:`.halo`,
  :mod:`.adi_sharded`, :mod:`.dist_tridiag`); ``make_grid_mesh`` builds it.

Every sharded function keeps the reference's global-in, global-out
contract: each rank calls it with the same global arguments, computes its
shard, and returns the same global result.

An ``axis_name`` argument (``lsm.lsm_backward_induction``,
``slv.calibrate_leverage``, :func:`psum`) names a dimension of the mesh in
use, which is the one entered with :func:`using_mesh` on this thread (the
sharded entry points enter their ``mesh`` themselves); the collective runs
over that dimension's process group.  This takes the place of
``shard_map``'s named axes.

The card's backend is NCCL; gloo carries the CPU ranks, and only when the
caller asks for the CPU.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import contextlib
import contextvars
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..calibrate.lm import _full_fp32_matmul
from ..core.precision import resolve_device, result_dtype
from ..models import heston as heston_model
from ..models.heston import HestonParams

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "sharded_calibration_step",
    "best_factorization",
    "using_mesh",
    "psum",
]

_ACTIVE = contextvars.ContextVar("pde_tpu_torch_mesh", default=None)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    timeout: Optional[timedelta] = None,
) -> int:
    """Join this process to a ``torch.distributed`` group: one process a
    device, ``num_processes`` of them, this one ``process_id``.

    A bare call is a no-op that returns the world size (1 when no group is
    up).  Explicit arguments join a group, and all three are needed:
    nothing on the machine describes a cluster, so nothing is read from the
    environment.  ``coordinator_address`` is a rendezvous URL
    (``tcp://host:port``, or ``file:///path`` for a file store on one host);
    a bare ``host:port`` reads as ``tcp://host:port``.  ``device=None`` is
    the card (``core/precision.default_device``; a rank takes card
    ``process_id`` modulo the cards it sees), whose backend is NCCL; gloo
    only when ``device`` names the CPU.  ``timeout`` bounds every
    collective (default 300 s).  Returns the world size.
    """
    if coordinator_address is None and num_processes is None and process_id is None:
        return dist.get_world_size() if dist.is_initialized() else 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address, num_processes "
                         "and process_id together")
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(dev.index if dev.index is not None
                              else process_id % torch.cuda.device_count())
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for device {dev}")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=timeout or timedelta(seconds=300))
    return dist.get_world_size()


def best_factorization(n: int, n_underlyings: Optional[int] = None) -> tuple[int, int]:
    """Factor n devices into (dp, quotes) mesh axes.

    With ``n_underlyings`` given, the choice follows communication counting
    rather than squareness: the dp axis carries NO collective traffic
    (surfaces are independent) while the quotes axis all-reduces every
    J^T J / J^T r / objective contraction — so dp should be as large as the
    workload can fill.  ``dp = `` the largest divisor of n that also
    divides U (perfect balance: every dp shard gets U/dp whole surfaces —
    a dp that is merely <= U cannot lay the U axis out over the mesh at
    all, e.g. U=6 on 8 devices must pick dp=2, not dp=4); when n divides U
    that is pure dp with zero collectives.  Without a workload hint, fall
    back to the most even split (dp >= quotes) — a neutral default for
    unknown U.  ``calibrate_batch`` additionally pads U up to a dp multiple
    when handed a mesh whose dp does not divide U.
    """
    if n_underlyings is not None and n_underlyings > 0:
        dp = max(
            d for d in range(1, n + 1)
            if n % d == 0 and n_underlyings % d == 0
        )
        return (dp, n // dp)
    best = (n, 1)
    for q in range(1, int(np.sqrt(n)) + 1):
        if n % q == 0:
            best = (n // q, q)
    return best


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("dp", "quotes"),
    shape: Optional[Sequence[int]] = None,
    n_underlyings: Optional[int] = None,
    *,
    device_type: Optional[str] = None,
):
    """Build a ``DeviceMesh`` over the ranks of the process group.

    One rank is one device, so ``n_devices`` (default: the world size) must
    be the world size.  The default factorization puts the larger axis on
    ``dp`` and the smaller on ``quotes``; ``n_underlyings`` sizes dp to the
    workload (:func:`best_factorization`).  ``device_type`` is ``"cuda"``
    by default, on an NCCL group, and raises without a card; ``"cpu"``, on
    a gloo group, only when asked.  Call :func:`initialize_distributed`
    first.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if device_type is None:
        resolve_device(None)  # the card, or the port's no-card error
        device_type = "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call initialize_distributed first")
    backend = dist.get_backend()
    if (device_type == "cuda") != (backend == "nccl"):
        raise RuntimeError(f"make_mesh: a {device_type} mesh cannot run on the {backend} "
                           "group (NCCL for the card, gloo for the CPU)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked of a world of {world} ranks "
                         "(one rank a device)")
    if shape is None:
        shape = best_factorization(n, n_underlyings)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not lay {n} ranks over {tuple(axis_names)}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


# ----------------------------------------------------------- the mesh in use


@contextlib.contextmanager
def using_mesh(mesh):
    """Make ``mesh`` the mesh whose dimensions ``axis_name`` arguments name
    (on this thread and its context) for the duration of the block."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def _mesh_in_use(axis_name):
    mesh = _ACTIVE.get()
    if mesh is None:
        raise ValueError(f"axis_name={axis_name!r} names no mesh dimension: no mesh is in "
                         "use (enter pde_tpu_torch.parallel.using_mesh(mesh))")
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"axis_name={axis_name!r} is not a dimension of the mesh in use "
                         f"{mesh.mesh_dim_names}")
    return mesh


def mesh_device(mesh) -> torch.device:
    """The device this rank's shard of ``mesh`` lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def on_mesh_device(mesh, device) -> bool:
    """Whether ``device`` is this rank's device of ``mesh``.  A device with
    no index is the current one of its type, as ``torch.device("cuda")``
    is, so it matches ``cuda:<current>``."""
    here, device = mesh_device(mesh), torch.device(device)
    return here.type == device.type and device.index in (None, here.index or 0)


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over the ranks along ``axis_name``
    of the mesh in use, as a new tensor on every one of them."""
    mesh = _mesh_in_use(axis_name)
    out = x.detach().clone().contiguous()
    if axis_size(mesh, axis_name) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(axis_name))
    return out


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The shards ``x`` of every rank along ``axis``, concatenated along
    ``dim`` in rank order (equal shapes on every rank)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def _global(x, dtype, device) -> torch.Tensor:
    """A global argument (number, array or tensor) on this rank's device."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} not divisible by axis size {parts}")
    m = n // parts
    return slice(index * m, (index + 1) * m)


# ------------------------------------------------------ the calibration step


def _price_population(x, strikes, maturities, S0, r, q, is_call=True,
                      n_points=64):
    """Vectorized pricing for mesh-sharded calibration.

    Prices on the Euler-Maclaurin-corrected Gauss-Legendre rule
    (models/heston.py:_gl_ref_rule): numerically the reference 1024 x 0.01
    objective (~1e-9 price agreement) at 15x fewer quadrature points, so
    the sharded LM refinement optimizes the same objective as the
    single-device stage, which prices through the same rule.
    """
    p = HestonParams(x[..., 0], x[..., 1], x[..., 2], x[..., 3], x[..., 4])
    return heston_model.price_carr_madan_gl(
        p, strikes, maturities, S0, r, q, is_call=is_call,
        n_points=n_points,
    )


def sharded_calibration_step(mesh, lower, upper):
    """One-iteration batched LM calibration step over a (dp, quotes) mesh.

    Inputs (U = underlyings, Q = quotes per surface), global on every rank:
      x          (U, 5)  current parameter iterates    -> rows over dp
      strikes    (U, Q)  quote strikes                 -> blocks over (dp, quotes)
      maturities (U, Q)                                -> blocks over (dp, quotes)
      target     (U, Q)  market prices                 -> blocks over (dp, quotes)
      lam        (U,)    LM damping                    -> rows over dp

    Returns ``(x_new, cost, lam_new)``, global, on every rank.  Each rank
    prices its (dp, quotes) block and builds its J (by ``jacfwd``), J^T J,
    J^T r and cost locally; one ``all_reduce`` over the ``quotes`` group
    sums them (and one more the trial cost), every rank of that group then
    takes the same damped step, and one ``all_gather`` over ``dp`` puts
    the U rows together.  The step stays one LM iteration.  It runs on the
    mesh's device, in the dtype of ``x`` (float64 for a float64 array,
    torch's default float for numbers).  U must divide by the dp size and
    Q by the quotes size, as the reference's shardings require.
    """
    dev = mesh_device(mesh)
    i_dp, n_dp = axis_index(mesh, "dp"), axis_size(mesh, "dp")
    i_q, n_q = axis_index(mesh, "quotes"), axis_size(mesh, "quotes")

    def quotes_sum(t):
        if n_q > 1:
            t = t.contiguous()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group("quotes"))
        return t

    def step(x, strikes, maturities, target, lam, S0, r, q, is_call=True):
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        dtype = result_dtype(x)
        x = x.to(device=dev, dtype=dtype)
        strikes, maturities, target, lam = (
            _global(a, dtype, dev) for a in (strikes, maturities, target, lam))
        lo, hi = _global(lower, dtype, dev), _global(upper, dtype, dev)
        U, Q = strikes.shape
        rows = _block(U, n_dp, i_dp, "underlyings")
        cols = _block(Q, n_q, i_q, "quotes")
        x_l, lam_l = x[rows], lam[rows]
        k_l, t_l, y_l = (a[rows, cols] for a in (strikes, maturities, target))

        def residuals_one(xi, ki, ti, yi):
            prices = torch.clamp_min(_price_population(xi, ki, ti, S0, r, q, is_call), 1e-10)
            return (prices - yi) / yi

        res_b = torch.func.vmap(residuals_one)
        jac_b = torch.func.vmap(torch.func.jacfwd(residuals_one))
        u_l = x_l.shape[0]
        with _full_fp32_matmul():  # TF32 would swamp the ill-conditioned J^T J
            res = res_b(x_l, k_l, t_l, y_l)                       # (u, q)
            J = jac_b(x_l, k_l, t_l, y_l)                         # (u, q, 5)
            JT = J.transpose(-1, -2)
            local = torch.cat([(JT @ J).reshape(u_l, 25), (JT @ res[..., None])[..., 0],
                               0.5 * torch.sum(res * res, -1, keepdim=True)], -1)
            tot = quotes_sum(local)                               # the quotes all-reduce
            JTJ, JTr, cost_old = tot[:, :25].reshape(u_l, 5, 5), tot[:, 25:30], tot[:, 30]
            eye = torch.eye(5, dtype=dtype, device=dev)
            A = JTJ + lam_l[:, None, None] * torch.diag_embed(
                torch.clamp_min(torch.diagonal(JTJ, dim1=-2, dim2=-1), 1e-12))
            delta = -torch.linalg.solve(A + 1e-14 * eye, JTr)
            x_new = torch.clamp(x_l + delta, lo, hi)
            res_new = res_b(x_new, k_l, t_l, y_l)
            cost_new = quotes_sum(0.5 * torch.sum(res_new * res_new, -1))
        accept = cost_new < cost_old
        out = torch.stack([*torch.where(accept[:, None], x_new, x_l).T,
                           torch.where(accept, cost_new, cost_old),
                           torch.where(accept, lam_l / 3.0, lam_l * 2.0)], -1)
        out = all_gather(out, mesh, "dp")                          # (U, 7)
        return out[:, :5].contiguous(), out[:, 5].contiguous(), out[:, 6].contiguous()

    return step
