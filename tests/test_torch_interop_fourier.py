"""The ``interop`` converters of the Fourier-priced models' parameters:
each JAX params record, read as numpy arrays, becomes the port's record,
and both packages then price the same thing."""

import numpy as np
import pytest
import torch

from pde_tpu.models import bates as jb
from pde_tpu.models import forward_start as jf
from pde_tpu.models import heston as jh
from pde_tpu.models import rough_heston as jr
from pde_tpu.models import svcj as js
from pde_tpu.models import term_heston as jt
from pde_tpu_torch import interop
from pde_tpu_torch.models import heston as th
from pde_tpu_torch.models import rough_heston as tr

K = np.linspace(80.0, 120.0, 7)
S0, R, Q = 100.0, 0.05, 0.02

CASES = {
    "bates": (lambda: jb.BatesParams(2.0, 0.04, 0.3, -0.7, 0.04, 0.6, -0.08, 0.18),
              interop.bates_params),
    "svcj": (lambda: js.SVCJParams(2.0, 0.04, 0.3, -0.7, 0.04, 0.5, -0.1, 0.15, 0.05, -0.5),
             interop.svcj_params),
    "term_heston": (lambda: jt.make_term_params([0.0, 0.5, 2.0], [2.0, 1.0], [0.04, 0.06],
                                                [0.3, 0.5], [-0.7, -0.4], 0.04),
                    interop.term_heston_params),
    "forward_start": (lambda: jf.ForwardStartParams(2.0, 0.04, 0.3, -0.7, 0.04, 0.5),
                      interop.forward_start_params),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_prices_the_same(name):
    make, convert = CASES[name]
    jp = make()
    tp = convert(jp)
    assert type(tp).__name__ == type(jp).__name__ and tp._fields == jp._fields
    for k in tp._fields:
        got = getattr(tp, k)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jp, k)))
    want = np.asarray(jh.price_accurate(jp, K, 0.8, S0, R, Q))
    got = th.price_accurate(tp, interop.tensor(K), interop.tensor(0.8), S0, R, Q)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)


def test_rough_round_trip_prices_the_same():
    jp = jr.RoughHestonParams(0.1, 2.0, 0.04, 0.3, -0.7, 0.04)
    tp = interop.rough_heston_params(jp)
    assert tp._fields == jp._fields
    assert tuple(float(x) for x in tp) == tuple(jp)
    want = np.asarray(jr.price_rough(jp, K, 0.5, S0, R, Q, n_steps=10))
    got = tr.price_rough(tp, interop.tensor(K), interop.tensor(0.5), S0, R, Q, n_steps=10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)


def test_converters_take_a_dtype():
    tp = interop.bates_params(CASES["bates"][0](), dtype=torch.float32)
    assert all(x.dtype == torch.float32 for x in tp)
