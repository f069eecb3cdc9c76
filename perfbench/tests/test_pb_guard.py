"""The check on loaded modules compares top-level names whole, and nothing
the harness, its references or the port load is JAX or the JAX package."""

import ast
import json
import subprocess
import sys

from conftest import ROOT

from perfbench import guard


def test_names_are_compared_whole():
    names = ["pde_tpu_torch", "pde_tpu_torch.solvers.heston_adi", "jaxtyping", "flaxen",
             "perfbench.run", "numpy"]
    assert guard.forbidden_modules(names) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "pde_tpu", "pde_tpu.ops.tridiag"]
    assert guard.forbidden_modules(names + bad) == sorted(bad)


def test_a_run_loads_no_jax():
    """Import everything a run imports, entries and references with the
    port's modules they reach, in a fresh interpreter."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from perfbench import run, control, manifest, guard
man = manifest.Manifest(manifest.Path({str(ROOT)!r}))
for w in man.data["workloads"]:
    cell = man.cell(w["name"])
    man.entry(man.traffic(cell.traffic)["entry"])
    for m in man.metrics(cell.name, False) + man.metrics(cell.name, True):
        man.reader(m["name"])
import pde_tpu_torch.solvers.heston_adi, pde_tpu_torch.solvers.local_vol_pde
import pde_tpu_torch.models.heston, pde_tpu_torch.models.local_vol
print(json.dumps(guard.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_references_import_nothing_of_the_port():
    """The plain references import only the standard library, numpy,
    torch and each other."""
    for path in (ROOT / "perfbench/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = ["." if node.level else node.module.split(".")[0]]
            else:
                continue
            assert set(tops) <= {"__future__", "math", "numpy", "torch", "."}, (path, tops)


def test_a_run_with_jax_loaded_prints_no_result(tiny_root, run_cell, monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res = run_cell(tiny_root, "heston_sv.cf_universe")
    assert rc == 3 and res is None
