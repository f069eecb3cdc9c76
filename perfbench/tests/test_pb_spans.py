"""``perfbench.spans`` and the metrics that read it, on hand-built traces:
device operations matched to launch calls by order, a ``cuLaunchKernel``
inside a ``cudaLaunchKernel`` counted once, a call with one operation too
many left out and counted, idle time split by overlap among nested spans
and the harness, and every span metric None on a trace without program
spans."""

import pytest
from conftest import ROOT

from perfbench import run, spans
from perfbench.manifest import Manifest
from perfbench.trace import CALL, WINDOW, TraceView

ENTRY = "pde_tpu_torch.heston_adi.solve_fused_batch"
SPAN_METRICS = ("bands_device_ms", "readout_device_ms", "pricer_device_ms",
                "port_launches_per_call", "port_idle_ms")
LENGTH = 100.0   # µs a call
OFFSET = -30.0   # the device's clock less the host's, µs


def x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def call(t0, program=True, extra_op=False):
    """One call at ``t0``: the entry span holds bands, march (the kernel's
    launch span inside it) and readout; the harness stacks and copies to
    the host.  Each operation starts 1-2 µs after its launch, on a device
    clock ``OFFSET`` µs off the host's: the next call's first operations
    then lie in this call's host time, and only order puts them in theirs."""
    host = [x(CALL, "user_annotation", t0, LENGTH)]
    if program:
        host += [x(ENTRY, "user_annotation", t0 + 5, 85),
                 x("pde_tpu_torch.heston_adi.bands", "user_annotation", t0 + 10, 20),
                 x("pde_tpu_torch.heston_adi.march", "user_annotation", t0 + 30, 30),
                 x("pde_tpu_torch.ops.adi_fused.launch", "user_annotation", t0 + 34, 4),
                 x("pde_tpu_torch.heston_adi.readout", "user_annotation", t0 + 60, 25)]
    host += [x("cudaLaunchKernel", "cuda_runtime", t0 + 12, 2),
             x("cudaLaunchKernel", "cuda_runtime", t0 + 35, 2),
             x("cuLaunchKernel", "cuda_driver", t0 + 35.5, 1),   # the same launch
             x("cudaLaunchKernel", "cuda_runtime", t0 + 62, 2),
             x("cudaLaunchKernel", "cuda_runtime", t0 + 91, 1),
             x("cudaMemcpyAsync", "cuda_runtime", t0 + 93, 6)]
    d = t0 + OFFSET
    device = [x("elementwise_bands", "kernel", d + 14, 4),
              x("douglas_march_smem", "kernel", d + 37, 18),
              x("elementwise_readout", "kernel", d + 64, 5),
              x("CatArrayBatchedCopy", "kernel", d + 92, 1),
              x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", d + 94, 4)]
    if extra_op:   # an operation no launch made, between two launched ones
        device.append(x("Memset (Device)", "gpu_memset", d + 20, 1))
    return host + device


def view(n_calls, bad=(), program=True):
    events = [x(WINDOW, "user_annotation", -50.0, n_calls * LENGTH + 100)]
    for i in range(n_calls):
        events += call(i * LENGTH, program, extra_op=i in bad)
    return TraceView(events)


def metric(name, trace):
    r = run.Run(setup_s=1.0, window_s=trace.window_us * 1e-6, work_done=1, work_per_call=1,
                shapes={}, kernel=None, trace=trace)
    return Manifest(ROOT).reader(name).read(r)


def test_device_ops_matched_to_launches_in_order():
    t = view(3)
    # by its own time the second call's band kernel is in the first call
    assert t.call_of(t.kernels_named("elementwise_bands")[1].start) == 0
    r = spans.read(t)
    assert r.calls == 3 and r.unmatched == 0
    for _, ops in r.matched:
        assert [o.owner for o in ops] == [
            "pde_tpu_torch.heston_adi.bands", "pde_tpu_torch.ops.adi_fused.launch",
            "pde_tpu_torch.heston_adi.readout", spans.HARNESS, spans.HARNESS]
        assert ops[1].stack == (ENTRY, "pde_tpu_torch.heston_adi.march",
                                "pde_tpu_torch.ops.adi_fused.launch")
    bands, readout = metric("bands_device_ms", t), metric("readout_device_ms", t)
    assert bands["value"] == pytest.approx(0.004) and bands["launches"] == 1
    assert bands["host_ms"] == pytest.approx(0.020)
    assert readout["value"] == pytest.approx(0.005) and readout["host_ms"] == pytest.approx(0.025)
    by_span = bands["device_ms_by_span"]
    assert by_span["pde_tpu_torch.ops.adi_fused.launch"] == pytest.approx(0.018)
    assert by_span[spans.HARNESS] == pytest.approx(0.005)
    launches = metric("port_launches_per_call", t)
    assert launches["value"] == 3 and launches["unmatched_calls"] == 0
    assert launches["kernels_by_span"][spans.HARNESS] == 1
    assert launches["copies_by_span"] == {spans.HARNESS: 1}
    # with the harness's kernel, every kernel of the window a call
    assert launches["value"] + 1 == metric("launches_per_call", t)


def test_a_nested_launch_counts_once():
    t = view(1)
    names = [s.name for s in spans.launch_calls(t.host)]
    assert names == ["cudaLaunchKernel"] * 4 + ["cudaMemcpyAsync"]
    lone = TraceView([x(WINDOW, "user_annotation", 0, 10),
                      x("cuLaunchKernel", "cuda_driver", 1, 1),
                      x("cuLaunchKernel", "cuda_driver", 3, 1)])
    assert len(spans.launch_calls(lone.host)) == 2


def test_a_call_with_one_op_too_many_is_left_out_and_counted():
    t = view(40, bad={7})
    r = spans.read(t)
    assert r.unmatched == 1 and len(r.matched) == 39 and r.sound
    assert [c.start for c, _ in r.matched].count(8 * LENGTH) == 1   # the next call realigns
    assert metric("port_launches_per_call", t)["unmatched_calls"] == 1
    assert metric("bands_device_ms", t)["value"] == pytest.approx(0.004)
    # past the share allowed, the metric reads no value and says why
    t = view(4, bad={1})
    assert metric("bands_device_ms", t) == {"value": None, "unmatched_calls": 1, "calls": 4}
    assert metric("port_launches_per_call", t)["value"] is None


def test_idle_split_by_overlap_among_nested_spans_and_the_harness():
    """Each idle stretch, put on the host's clock where the next operation
    was launched, split among the spans open then: entry, bands and march
    nest, the launch span inside march, the harness outside them all."""
    t = view(2)
    idle = metric("port_idle_ms", t)
    by_span = idle["idle_ms_by_span"]
    want = {spans.HARNESS: 122, ENTRY: 20, "pde_tpu_torch.heston_adi.bands": 32,
            "pde_tpu_torch.heston_adi.march": 22, "pde_tpu_torch.ops.adi_fused.launch": 2,
            "pde_tpu_torch.heston_adi.readout": 38}
    assert by_span == pytest.approx({k: v / 2 * 1e-3 for k, v in want.items()})
    assert idle["value"] == pytest.approx(0.057)
    # port and harness together: the window's idle share over the calls
    pct = metric("device_idle_pct.book", t)
    assert sum(by_span.values()) == pytest.approx(pct / 100 * t.window_us * 1e-3 / 2)
    # stretches shifted by different offsets may arrive out of order
    pieces = [(0.0, 10.0, ("a",)), (10.0, 20.0, ("a", "b"))]
    assert spans.split([(12.0, 15.0), (2.0, 4.0), (18.0, 25.0)], pieces) == {
        "a": 2.0, "b": 5.0, spans.HARNESS: 5.0}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_no_program_spans_no_reading(name):
    assert metric(name, view(3, program=False)) is None
