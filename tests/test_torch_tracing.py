"""The program's spans (``pde_tpu_torch.utils.profiling.span``) on the CPU,
on the three paths the benchmark runs: the Heston ADI book
(``heston_adi.solve_fused_batch``), the local-vol CN book
(``local_vol_pde.solve_fused_batch``, fused route) and the Fourier pricer
(``heston.price_carr_madan_gl``).

- under ``torch.profiler`` each path emits its entry span and its phases,
  each phase's parent the entry span; the kernel-launch spans are absent,
  since the CPU runs the kernels' plain twins;
- with no profiler on, no span enters ``record_function``;
- the results are bit-identical with and without a profiler;
- ``profiling.trace`` writes a Chrome trace that holds the span names.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pde_tpu_torch.models import heston
from pde_tpu_torch.models.local_vol import SurfaceInterpolator
from pde_tpu_torch.solvers import heston_adi, local_vol_pde
from pde_tpu_torch.utils import profiling

F32 = torch.float32


def adi_book():
    res = heston_adi.solve_fused_batch(
        [1.5, 2.0, 3.0], 0.04, 0.3, -0.7, [0.04, 0.05, 0.03], 0.05, 0.02,
        [0.5, 1.0, 0.25], [95.0, 105.0, 100.0], [1.0, 0.0, 1.0], 100.0,
        n_spot=20, n_vol=10, n_time=8, device="cpu")
    return res._asdict()


def cn_book():
    rng = np.random.default_rng(7)
    interp = SurfaceInterpolator(np.linspace(60.0, 170.0, 6), np.array([0.05, 0.5, 1.0]),
                                 (0.15 + 0.1 * rng.random((3, 6))), device="cpu", dtype=F32)
    res = local_vol_pde.solve_fused_batch(
        interp, 100.0, K=[90.0, 100.0, 110.0, 120.0], T=[0.25, 0.5, 1.0, 1.5], r=0.04,
        q=0.01, is_call=[1.0, 0.0, 1.0, 0.0], n_space=24, n_time=8, route="fused",
        device="cpu")
    return res._asdict()


def cf_book():
    col = lambda *a: torch.tensor(a, dtype=F32)[:, None]  # noqa: E731
    params = heston.HestonParams(col(1.5, 2.0, 3.0), col(0.04, 0.05, 0.03),
                                 col(0.3, 0.4, 0.5), col(-0.7, -0.5, -0.3),
                                 col(0.04, 0.05, 0.03))
    t = lambda *a: torch.tensor(a, dtype=F32)  # noqa: E731
    price = heston.price_carr_madan_gl(params, t(90.0, 100.0, 110.0), t(0.5, 1.0, 0.02),
                                       t(100.0, 100.0, 100.0), t(0.05, 0.05, 0.05),
                                       t(0.02, 0.02, 0.02), t(1.0, 0.0, 1.0) > 0.5)
    return {"price": price}


PATHS = {
    "adi": (adi_book, "pde_tpu_torch.heston_adi.solve_fused_batch",
            ("bands", "march", "readout")),
    "cn": (cn_book, "pde_tpu_torch.local_vol_pde.solve_fused_batch",
           ("bands", "march", "readout")),
    "cf": (cf_book, "pde_tpu_torch.heston.price_carr_madan_gl",
           ("rule", "integrand", "price")),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_the_phases_nest_under_the_entry_span(path):
    run, entry, phases = PATHS[path]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = [e for e in prof.events() if e.name.startswith("pde_tpu_torch.")]
    module = entry.rsplit(".", 1)[0]
    assert sorted(e.name for e in spans) == sorted([entry] + [f"{module}.{p}" for p in phases])
    for e in spans:
        if e.name == entry:
            assert e.cpu_parent is None
        else:
            assert e.cpu_parent is not None and e.cpu_parent.name == entry
            assert e.cpu_parent.time_range.start <= e.time_range.start
            assert e.time_range.end <= e.cpu_parent.time_range.end
    starts = {e.name.rsplit(".", 1)[1]: e.time_range.start for e in spans if e.name != entry}
    assert sorted(phases, key=starts.get) == list(phases)
    assert not any(e.name.endswith(".launch") for e in spans)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_profiler_no_record_function(path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler on")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    out = PATHS[path][0]()
    assert all(torch.isfinite(v).all() for v in out.values() if v.is_floating_point())


@pytest.mark.parametrize("path", sorted(PATHS))
def test_results_bit_identical_under_a_profiler(path):
    run = PATHS[path][0]
    plain = run()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k


def test_span_off_is_one_shared_null_context():
    a, b = profiling.span("pde_tpu_torch.x.a"), profiling.span("pde_tpu_torch.x.b")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("pde_tpu_torch.x.a")
    assert on is not a


def test_trace_writes_the_span_names(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as log_dir:
        cf_book()
    with open(os.path.join(log_dir, "trace.json")) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"pde_tpu_torch.heston.price_carr_madan_gl", "pde_tpu_torch.heston.rule",
            "pde_tpu_torch.heston.integrand", "pde_tpu_torch.heston.price"} <= names
