"""Runs of the command itself: without a card it exits 2 and prints no
result; on a card (``cuda``-marked, skipped here) each cell gives the
contract's result line, and a copy holding only the benchmark's files
cannot run."""

import json
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def command(cell, seed=12345, seconds=1, trace=0, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                           str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=cwd, capture_output=True, text=True, timeout=900, env=env)


def test_without_a_card_no_result():
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = command(CELLS[0], env=env)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_on_the_card(card, cell, trace):
    out = command(cell, trace=trace)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert len(res["breakdown"]["device_ops"]) <= 10
        for name, m in res["metrics"].items():
            if name.endswith("_roofline"):
                assert 0 < m["value"] <= 100
    else:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2


@pytest.mark.cuda
def test_the_benchmark_alone_cannot_run(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(CELLS[0], cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
