"""Benchmark of ``pde_tpu_torch`` on one NVIDIA card: one cell a run.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file, its traffic mix (``traffic/<mix>.json``), the entry that
drives the port (``entries/<entry>.py``), its correctness limits
(``limits/<cell>.json``) and one reader a metric (``metrics/<name>.py``).
Nothing here imports JAX or ``pde_tpu``; the plain references under
``reference/`` import nothing of ``pde_tpu_torch`` either.
"""
