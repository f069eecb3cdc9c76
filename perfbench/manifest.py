"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one its entry in ``configs`` gives; the mix
is ``perfbench/traffic/<traffic>.json``, which names the entry module
``perfbench/entries/<entry>.py`` that drives the port; the cell's limits
are ``perfbench/limits/<cell>.json``; each metric is read by
``perfbench/metrics/<metric>.py``.  Adding a cell, a mix or a metric is
adding files and entries: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


class Manifest:
    """The parsed ``BENCHMARK.json`` of a checkout rooted at ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench_dir = self.root / "perfbench"

    def cell(self, name: str) -> Cell:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return Cell(w["name"], w["config"], w["traffic"], int(w["chips"]))
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.bench_dir / "limits" / f"{cell}.json").read_text())

    def entry(self, name: str):
        return load_module(self.bench_dir / "entries" / f"{name}.py", f"entries.{name}")

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py", f"metrics.{metric}")

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer metrics
        (traced): those whose ``workloads`` list the cell, and those with no
        such list (a per-layer one then only where the cell reports the
        end-to-end metric it moves)."""
        e2e = [m for m in self.data["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not traced:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in reported)]


def load_module(path: Path, name: str):
    """Import ``path`` under ``perfbench.<name>``; the file's name may hold
    dots (``device_idle_pct.book.py``), so it is loaded by path."""
    full = f"perfbench.{name}"
    if full in sys.modules:
        return sys.modules[full]
    spec = importlib.util.spec_from_file_location(full, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[full] = module
    spec.loader.exec_module(module)
    return module
