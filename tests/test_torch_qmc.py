"""The port's Sobol' QMC (``pde_tpu_torch/core/qmc.py``) held against
``pde_tpu`` (x64) on the CPU.

Gates, each with its reason:
- direction numbers, Gray codes, Sobol words (plain, digitally shifted,
  Matousek-scrambled) and ``to_unit`` (float32 and float64): exactly equal.
  They are integer work, and ``to_unit`` is one exact product and sum in
  the dtype; the randomized words are fed the reference's own random bits
  (``jax.random.bits`` of the key, as numpy) through the private functions
  that take the words;
- ``sobol_normal`` / ``sobol_uniform``: the uniforms exactly, the normals at
  1e-12 relative (torch's and XLA's ``ndtri`` differ in the last digits);
- the public functions with a ``torch.Generator`` (Philox words, not
  threefry): the reference's own property tests, one-dimensional
  equidistribution over dyadic bins and the open interval.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.core import qmc as jq
from pde_tpu_torch.core import qmc as tq

CPU = torch.device("cpu")
F64 = torch.float64


def _bits(key, shape):
    return np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)


def _scrambled(dim, key):
    """(JAX's scrambled block, the port's from the same bits, the shift bits)."""
    k_lms, k_shift = jax.random.split(key)
    dv = jq.sobol_direction_numbers(dim)
    ref = np.asarray(jq.scramble_direction_numbers(dv, k_lms))
    got = tq._scramble_direction_numbers(dv, torch.as_tensor(_bits(k_lms, (dim, 32))))
    return ref, got, _bits(k_shift, (dim,))


@pytest.mark.parametrize("dim", [1, 7, 128])
def test_direction_numbers_match(dim):
    ref = jq.sobol_direction_numbers(dim)
    got = tq.sobol_direction_numbers(dim)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("offset", [0, 37, 2**32 - 5])
def test_gray_codes_match(offset):
    ref = np.asarray(jq.gray_codes(300, offset)).astype(np.int64)
    np.testing.assert_array_equal(tq.gray_codes(300, offset, device=CPU).numpy(), ref)


@pytest.mark.parametrize("dim,n,offset", [(3, 64, 0), (16, 1000, 0), (5, 257, 123)])
def test_plain_words_match(dim, n, offset):
    dv = jq.sobol_direction_numbers(dim)
    ref = np.asarray(jq.sobol_uint32(dv, n, index_offset=offset)).astype(np.int64)
    got = tq.sobol_uint32(dv, n, index_offset=offset, device=CPU)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 11])
def test_shifted_words_match_on_the_same_bits(seed):
    """``sobol_uint32(dv, n, key)``'s shift is ``bits(key, (dim,))``."""
    key = jax.random.PRNGKey(seed)
    dv = jq.sobol_direction_numbers(6)
    ref = np.asarray(jq.sobol_uint32(dv, 512, key)).astype(np.int64)
    got = tq._sobol_uint32(dv, 512, torch.as_tensor(_bits(key, (6,))), 0, CPU)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dim,seed", [(4, 11), (128, 3)])
def test_scrambled_words_match_on_the_same_bits(dim, seed):
    ref_dv, got_dv, shift = _scrambled(dim, jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(got_dv.numpy(), ref_dv.astype(np.int64))
    g = tq.gray_codes(777, device=CPU)
    ref = np.asarray(jq.sobol_uint32_from_gray(jq.gray_codes(777), ref_dv, shift.astype(
        np.uint32))).astype(np.int64)
    np.testing.assert_array_equal(tq.sobol_uint32_from_gray(g, got_dv, shift).numpy(), ref)


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32), (jnp.float64, F64)])
def test_to_unit_is_exact(jdt, tdt):
    words = _bits(jax.random.PRNGKey(4), (4096,))
    words[:4] = [0, 0xFFFFFFFF, 0xFFFFFF00, 0x80000000]
    ref = np.asarray(jq.to_unit(jnp.asarray(words.astype(np.uint32)), jdt))
    got = tq.to_unit(torch.as_tensor(words), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), ref)


def test_unshifted_uniform_and_normal_match():
    dv = jq.sobol_direction_numbers(9)
    np.testing.assert_array_equal(
        tq.sobol_uniform(dv, 1024, dtype=F64, device=CPU).numpy(),
        np.asarray(jq.sobol_uniform(dv, 1024, dtype=jnp.float64)))
    np.testing.assert_allclose(
        tq.sobol_normal(dv, 1024, dtype=F64, device=CPU).numpy(),
        np.asarray(jq.sobol_normal(dv, 1024, dtype=jnp.float64)), rtol=1e-12, atol=0.0)


def test_randomized_normal_matches_on_the_same_bits():
    """LMS + shift, as ``heston_mc``'s Sobol sampler uses them, at 1e-12."""
    key = jax.random.PRNGKey(21)
    ref_dv, got_dv, shift = _scrambled(12, key)
    k2 = jax.random.PRNGKey(22)
    ref = np.asarray(jq.sobol_normal(ref_dv, 2048, k2, dtype=jnp.float64))
    words = tq._sobol_uint32(got_dv, 2048, torch.as_tensor(_bits(k2, (12,))), 0, CPU)
    got = torch.special.ndtri(tq.to_unit(words, F64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=0.0)


def test_generator_randomization_keeps_the_net():
    """Matousek LMS + digital shift from a torch.Generator keep each
    dimension's equidistribution over 16 dyadic bins exactly (the
    reference's ``test_scrambling_preserves_net_structure``), and two
    generator states give two randomizations."""
    g = torch.Generator().manual_seed(11)
    dv = tq.scramble_direction_numbers(tq.sobol_direction_numbers(4), g, device=CPU)
    u = tq.sobol_uniform(dv, 256, g, dtype=F64).numpy()
    for d in range(4):
        h, _ = np.histogram(u[:, d], bins=16, range=(0.0, 1.0))
        assert (h == 16).all()
    u2 = tq.sobol_uniform(dv, 256, g, dtype=F64).numpy()
    assert np.abs(u - u2).max() > 0.01


def test_open_interval_float32():
    dv = tq.sobol_direction_numbers(2)
    u = tq.sobol_uniform(dv, 128, dtype=torch.float32, device=CPU)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert bool(torch.isfinite(tq.sobol_normal(dv, 128, dtype=torch.float32,
                                               device=CPU)).all())


def test_gray_code_offset_continuation():
    dv = tq.sobol_direction_numbers(3)
    full = tq.sobol_uniform(dv, 64, dtype=F64, device=CPU)
    tail = tq.sobol_uniform(dv, 32, index_offset=32, dtype=F64, device=CPU)
    torch.testing.assert_close(full[32:], tail, rtol=0.0, atol=0.0)
