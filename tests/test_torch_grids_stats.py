"""``core/grids.log_grid``/``uniform_step`` and ``utils/stats`` mean,
variance and std of the port held against the JAX package: the same seeded
inputs, float64 on the CPU, at 1e-14 relative (the same arithmetic in the
same order, up to the last bit of ``log``/``exp``), and the same
``ValueError``s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.core import grids as jgrids
from pde_tpu.utils import stats as jstats
from pde_tpu_torch import interop
from pde_tpu_torch.core import grids as tgrids
from pde_tpu_torch.utils import stats as tstats

F64 = torch.float64


@pytest.mark.parametrize("x_min,x_max,n", [(50.0, 200.0, 3), (1e-3, 7.5, 41), (0.2, 0.3, 200)])
def test_log_grid_matches_reference(x_min, x_max, n):
    got = tgrids.log_grid(x_min, x_max, n, dtype=F64, device="cpu")
    want = np.asarray(jgrids.log_grid(x_min, x_max, n, dtype=jnp.float64))
    assert got.device.type == "cpu" and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)


@pytest.mark.parametrize("args,match", [
    ((1.0, 2.0, 2), "at least 3 points"),
    ((0.0, 2.0, 5), "x_min > 0"),
    ((-1.0, 2.0, 5), "x_min > 0"),
    ((2.0, 2.0, 5), "less than x_max"),
    ((3.0, 2.0, 5), "less than x_max"),
])
def test_log_grid_raises_as_reference(args, match):
    with pytest.raises(ValueError, match=match):
        jgrids.log_grid(*args)
    with pytest.raises(ValueError, match=match):
        tgrids.log_grid(*args, device="cpu")


@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_uniform_step_matches_reference(rng, log_space, batched):
    grid = np.sort(rng.uniform(10.0, 300.0, (4, 17) if batched else (17,)), axis=-1)
    got = tgrids.uniform_step(interop.tensor(grid), log_space=log_space)
    want = np.asarray(jgrids.uniform_step(jnp.asarray(grid), log_space=log_space))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)


def test_uniform_step_of_its_own_grids():
    lin = tgrids.uniform_grid(-1.0, 3.0, 9, dtype=F64, device="cpu")
    log = tgrids.log_grid(1.0, 256.0, 9, dtype=F64, device="cpu")
    assert float(tgrids.uniform_step(lin)) == pytest.approx(0.5, abs=1e-15)
    assert float(tgrids.uniform_step(log, log_space=True)) == pytest.approx(
        np.log(2.0), abs=1e-15)


@pytest.mark.parametrize("name", ["mean", "variance", "std_dev"])
@pytest.mark.parametrize("axis", [None, 0, 1, -1, (0, 2)])
def test_stats_match_reference(rng, name, axis):
    x = rng.normal(3.0, 2.0, (5, 6, 7))
    got = getattr(tstats, name)(interop.tensor(x), axis=axis)
    want = np.asarray(getattr(jstats, name)(jnp.asarray(x), axis=axis))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)


@pytest.mark.parametrize("name", ["variance", "std_dev"])
@pytest.mark.parametrize("ddof", [0, 1, 2])
def test_stats_ddof_matches_reference(rng, name, ddof):
    x = rng.normal(size=(9, 4))
    for axis in (None, 0):
        got = getattr(tstats, name)(interop.tensor(x), axis=axis, ddof=ddof)
        want = np.asarray(getattr(jstats, name)(jnp.asarray(x), axis=axis, ddof=ddof))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)


def test_sample_variance_is_the_default():
    """ddof=1 by default, as the reference's math utils."""
    x = torch.tensor([1.0, 2.0, 4.0, 7.0], dtype=F64)
    assert float(tstats.variance(x)) == pytest.approx(np.var([1, 2, 4, 7], ddof=1))
    assert float(tstats.std_dev(x)) == pytest.approx(np.std([1, 2, 4, 7], ddof=1))
    assert float(tstats.mean(x)) == 3.5
