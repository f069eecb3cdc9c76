"""Fixtures of the benchmark's own tests (``python -m pytest perfbench/tests``).

``tiny_root`` is a copy of the benchmark (``BENCHMARK.json`` and
``perfbench/``) whose configurations and mixes are cut to sizes the CPU
runs in a second; the port itself is imported from the checkout.  ``card``
skips a test where there is no CUDA card, deciding when the test runs."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "configs/heston_sv.json": {"grid": {"n_spot": 20, "n_vol": 10, "n_time": 8}},
    "configs/dupire_lv.json": {"grid": {"n_space": 24, "n_time": 8}},
    "traffic/adi_book.json": {"pool": 3, "book": {"underlyings": 2}},
    "traffic/cn_book.json": {"pool": 3, "book": {"options": 16}},
    "traffic/cf_universe.json": {"pool": 2, "book": {"underlyings": 8}},
}


def edit_json(path: Path, changes: dict) -> None:
    """Merge ``changes`` into the JSON object at ``path``, one level deep."""
    data = json.loads(path.read_text())
    for key, value in changes.items():
        if isinstance(value, dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data))


def copy_benchmark(dest: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_benchmark(tmp_path)
    for rel, changes in TINY.items():
        edit_json(root / "perfbench" / rel, changes)
    return root


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def run_cell(capsys):
    """Run a cell on the CPU in a copy of the benchmark; returns the exit
    code and the result line (None without one)."""
    from perfbench import run

    def go(root, workload, seed=2147483999, seconds=0.3, trace=0):
        capsys.readouterr()
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=root, device="cpu")
        lines = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None)

    return go
