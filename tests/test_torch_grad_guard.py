"""The port's kernel wrappers refuse autograd, as the reference's Pallas
kernels do.

A CUDA kernel writes its result into a fresh tensor, so the result carries
no gradient, and a readout that mixed it with differentiable operator terms
would return a wrong gradient without a word.  The reference's
``pallas_call`` has no JVP rule: under ``jax.grad`` it raises, in interpret
mode too.  So each of the port's six kernel wrappers raises when autograd
would run through it, on the card and, for the same inputs, on the CPU
where its plain twin stands in for the kernel; these tests check the CPU
side (tests/test_torch_cuda.py the card).  The differentiable routes keep
their gradients: ``tridiagonal_solve`` under grad takes ``thomas`` and
matches ``jax.grad`` at 1e-10 in float64, and the local-vol book's
``route="scan"`` matches the reference's scan route under ``jax.grad`` at
float32's gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.ops import tridiag as jt
from pde_tpu.solvers import heston_adi as ja
from pde_tpu.solvers import local_vol_pde as jpde
from pde_tpu_torch.ops import adi_fused, cn1d_fused, cn1d_tv_fused, tridiag
from pde_tpu_torch.solvers import bs_pde, heston_adi, lcp, local_vol_pde

F32 = torch.float32
GRID = dict(n_spot=12, n_vol=6, n_time=3)


def _flat(s, t):
    return torch.full_like(s, 0.2)


def _k1():
    ins, _ = heston_adi._march_inputs(*(torch.tensor(a, dtype=F32) for a in (
        [2.0, 1.5], [0.04, 0.05], [0.3, 0.4], [-0.7, -0.5], [0.05, 0.03], [0.02, 0.0],
        [1.0, 0.5], [100.0, 90.0], [1.0, 0.0], [0.0, 1.0])), *GRID.values(), 0.2, 5.0, 1.0)
    return list(ins), lambda *a: adi_fused.fused_douglas_march_batched(*a, *GRID.values())


def _k2():
    p = heston_adi.HestonPDEParams(q=0.02, **GRID)
    t = lambda k: torch.tensor(float(getattr(p, k)))  # noqa: E731
    args, _ = heston_adi._fused_inputs(p, *(t(k) for k in ("kappa", "theta", "sigma", "rho",
                                                           "r", "q", "T", "K")))
    return list(args), lambda *a: adi_fused.fused_douglas_march(*a, *GRID.values())


def _k3():
    t = lambda a: torch.tensor(a, dtype=F32)  # noqa: E731
    ins = local_vol_pde._march_inputs(_flat, t([100.0, 90.0]), t([1.0, 0.5]), t([1.0, 0.0]),
                                      t([0.0, 1.0]), 0.04, 0.01, 16, 3, 0.2, 5.0)[:3]
    return list(ins), lambda *a: cn1d_tv_fused.fused_cn_march_1d_tv(*a, 16, 3)


def _k4():
    t = lambda a: torch.tensor(a, dtype=F32)  # noqa: E731
    ins = bs_pde._march_inputs(t([0.2, 0.3]), t([0.05, 0.05]), t([0.01, 0.0]), t([1.0, 0.5]),
                               t([100.0, 90.0]), t([1.0, 0.0]), t([0.0, 1.0]), 16, 3, 0.2,
                               5.0)[:2]
    return list(ins), lambda *a: cn1d_fused.fused_cn_march_1d(*a, 16, 3)


def _system(rng, B, n):
    t = lambda a: torch.as_tensor(a, dtype=F32)  # noqa: E731
    return [t(rng.uniform(-1, 0, (B, n - 1))), t(2.5 + rng.uniform(0, 1, (B, n))),
            t(rng.uniform(-1, 0, (B, n - 1))), t(rng.normal(size=(B, n)))]


def _k5():
    return _system(np.random.default_rng(1), 4, 10), tridiag.thomas_batched


def _k6():
    system = _system(np.random.default_rng(2), 4, 10)
    return system + [torch.zeros(4, 10)], lambda *a: lcp.projected_sor_batched(*a)[0]


WRAPPERS = {"fused_douglas_march_batched": _k1, "fused_douglas_march": _k2,
            "fused_cn_march_1d_tv": _k3, "fused_cn_march_1d": _k4,
            "thomas_batched": _k5, "projected_sor_batched": _k6}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrapper_refuses_autograd(name):
    """Each kernel wrapper raises when an input requires grad and grad is
    enabled, naming itself and the differentiable routes; under
    torch.no_grad() the same call runs and equals the call on a detached
    input."""
    args, call = WRAPPERS[name]()
    want = call(*args)
    leaf = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward.*greeks_ad"):
        call(leaf, *args[1:])
    with torch.no_grad():
        got = call(leaf, *args[1:])
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_heston_book_raises_under_grad_as_the_reference():
    """solve_fused_batch on its kernel route, with kappa requiring grad,
    raises; the reference raises under jax.grad at the same inputs (its
    pallas_call has no JVP rule, interpret mode included)."""
    args = (0.04, 0.3, -0.7, 0.04, 0.05, 0.02, [1.0, 0.5], [100.0, 90.0], [1.0, 0.0], 100.0)
    kappa = torch.tensor([2.0, 1.5], requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        heston_adi.solve_fused_batch(kappa, *args, device="cpu", **GRID)
    with pytest.raises(AssertionError):
        jax.grad(lambda k: ja.solve_fused_batch(
            k, *(jnp.asarray(a) for a in args), interpret=True, **GRID).price.sum())(
            jnp.array([2.0, 1.5]))


def test_local_vol_book_raises_under_grad_as_the_reference():
    """local_vol_pde.solve_fused_batch on its kernel route, with K
    requiring grad, raises; so does the reference under jax.grad."""
    kw = dict(T=[1.0, 0.5], n_space=16, n_time=3)
    K = torch.tensor([100.0, 90.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        local_vol_pde.solve_fused_batch(_flat, 100.0, K=K, device="cpu", **kw)
    with pytest.raises(AssertionError):
        jax.grad(lambda k: jpde.solve_fused_batch(
            lambda s, t: jnp.full_like(s, 0.2), 100.0, K=k, interpret=True, **kw).price.sum())(
            jnp.array([100.0, 90.0]))


def test_local_vol_scan_route_keeps_its_gradient():
    """route="scan" launches no kernel: d price / d K by autograd, held
    against jax.grad of the reference's scan route (both float32, the
    reference's book gate 3e-5 relative / 2e-5 absolute)."""
    kw = dict(T=[1.0, 0.5], is_call=[0.0, 1.0], n_space=24, n_time=6, route="scan")
    want = jax.grad(lambda k: jpde.solve_fused_batch(
        lambda s, t: jnp.full_like(s, 0.2), 100.0, K=k, **kw).price.sum())(
        jnp.array([100.0, 90.0], jnp.float32))
    K = torch.tensor([100.0, 90.0], requires_grad=True)
    price = local_vol_pde.solve_fused_batch(_flat, 100.0, K=K, device="cpu", **kw).price
    got, = torch.autograd.grad(price.sum(), K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=2e-5)


def test_tridiagonal_solve_under_grad_takes_thomas(rng):
    """tridiagonal_solve's automatic choice asks kernel_route, so a call
    under grad goes to the differentiable thomas: its gradient equals
    jax.grad of the reference's thomas at 1e-10 in float64, and no kernel
    launches.  use_kernel=True under grad reaches the guard and raises."""
    B, n = 4, 12
    lower, upper = rng.uniform(-1, 0, (B, n - 1)), rng.uniform(-1, 0, (B, n - 1))
    diag, rhs = 2.5 + rng.uniform(0, 1, (B, n)), rng.normal(size=(B, n))
    w = rng.normal(size=(B, n))
    want = jax.grad(lambda *a: (jnp.asarray(w) * jt.thomas(*a)).sum(), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (lower, diag, upper, rhs)))
    args = [torch.as_tensor(a).requires_grad_() for a in (lower, diag, upper, rhs)]
    before = tridiag.thomas_batched.launches
    got = torch.autograd.grad((torch.as_tensor(w) * tridiag.tridiagonal_solve(*args)).sum(),
                              args)
    assert tridiag.thomas_batched.launches == before
    for name, g, h in zip(("lower", "diag", "upper", "rhs"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(h), rtol=1e-10, atol=1e-14,
                                   err_msg=name)
    f32 = [a.detach().float().requires_grad_() for a in args]
    with pytest.raises(RuntimeError, match="thomas_batched: .*no backward"):
        tridiag.tridiagonal_solve(*f32, use_kernel=True)


def test_refuse_autograd_reads_tensors_and_tuples():
    """The guard looks into tuples (K2 takes its bands as tuples), ignores
    what is not a tensor, and stands aside under torch.no_grad() or when
    nothing requires grad."""
    from pde_tpu_torch.ops.build import refuse_autograd

    x, leaf = torch.zeros(3), torch.zeros(3, requires_grad=True)
    refuse_autograd("k", x, (x, x), None, 1.0)
    with pytest.raises(RuntimeError, match="k: an input requires grad"):
        refuse_autograd("k", x, (x, leaf))
    with torch.no_grad():
        refuse_autograd("k", leaf)
