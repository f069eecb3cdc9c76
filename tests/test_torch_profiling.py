"""``pde_tpu_torch.utils.profiling`` on the CPU (mirrors
``tests/test_profiling.py``; the reference's TPU keep-alive has no twin).

- ``time_jitted`` splits the first call from the warm ones: the first of a
  callable that builds its state on first use takes longer than the median
  warm call, every warm call is timed, and the result is the callable's;
- ``trace`` writes a Chrome trace holding the profiled block's operators.
"""

import json
import os
import time

import torch

from pde_tpu_torch.utils.profiling import Timings, time_jitted, trace


def test_time_jitted_first_call_warm_call_split():
    built = {}

    def f(x):
        if "w" not in built:  # state built at first use, as a kernel's build
            time.sleep(0.05)
            built["w"] = torch.ones_like(x)
        return (x * x * built["w"]).sum()

    t = time_jitted(f, torch.arange(1024.0), n_runs=5)
    assert isinstance(t, Timings)
    assert t.compile_s > 0
    assert t.median_run_s > 0
    assert len(t.runs_s) == 5
    assert t.compile_s >= t.median_run_s
    assert t.median_run_s == sorted(t.runs_s)[2]
    assert t.per_second == 1.0 / t.median_run_s


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as log_dir:
        torch.linalg.solve(torch.eye(8) * 2.0, torch.ones(8, 2))
    assert log_dir == str(tmp_path / "t")
    with open(os.path.join(log_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("linalg" in str(e.get("name", "")) for e in events)
