"""The port's CUDA kernels on the card (marked ``cuda``; each test skips
without a GPU).  This file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch, from the repository root:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from pde_tpu_torch.ops import adi_fused
from pde_tpu_torch.solvers import heston_adi

# kernel vs plain twin: both float32 with the same step order; only FMA
# contraction differs
GATE = dict(rtol=1e-4, atol=1e-5)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _book(B, seed):
    """Seeded book (numpy draws) as solve_fused_batch arguments."""
    rng = np.random.default_rng(seed)
    draw = lambda lo, hi: rng.uniform(lo, hi, B)  # noqa: E731
    return dict(kappa=draw(1.0, 3.0), theta=draw(0.02, 0.08), sigma=draw(0.2, 0.5),
                rho=draw(-0.8, -0.3), v0=draw(0.02, 0.06), r=draw(0.0, 0.08),
                q=draw(0.0, 0.04), T=draw(0.3, 1.0), K=draw(80.0, 120.0),
                is_call=(rng.uniform(size=B) < 0.5), S0=100.0,
                american=(rng.uniform(size=B) < 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("use_it", [False, True])
def test_kernel_matches_plain(use_it):
    _need_cuda()
    book = _book(33, 1)
    args = heston_adi._broadcast_batch(*book.values(), "cuda")
    kappa, theta, sigma, rho, _, r, q, T, K, call, _, amer = args
    ins, _ = heston_adi._march_inputs(kappa, theta, sigma, rho, r, q, T, K, call,
                                      amer, 40, 20, 20, 0.2, 5.0, 1.0)
    before = adi_fused.fused_douglas_march_batched.launches
    got = adi_fused.fused_douglas_march_batched(*ins, 40, 20, 20, use_it=use_it)
    want = adi_fused._fused_douglas_march_batched_plain(*ins, 40, 20, 20, use_it)
    torch.cuda.synchronize()
    assert adi_fused.fused_douglas_march_batched.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["projection", "it_lcp"])
def test_book_on_card_matches_cpu(method):
    """solve_fused_batch through the kernel (card) and through the plain
    twin (CPU) on one book."""
    _need_cuda()
    book = _book(70, 2)
    kw = dict(n_spot=40, n_vol=20, n_time=20, american_method=method)
    on_card = heston_adi.solve_fused_batch(**book, **kw, device="cuda")
    on_cpu = heston_adi.solve_fused_batch(**book, **kw, device="cpu")
    for f in ("price", "delta", "gamma", "vega"):
        np.testing.assert_allclose(getattr(on_card, f).cpu().numpy(),
                                   getattr(on_cpu, f).numpy(), err_msg=f, **GATE)
