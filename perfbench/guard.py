"""The run's check that neither JAX nor the JAX package is loaded.

Names are compared whole, by the part before the first dot:
``pde_tpu_torch`` is the port and passes, ``pde_tpu`` and ``pde_tpu.ops``
fail."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pde_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """Loaded module names whose top-level name is forbidden, sorted."""
    names = sys.modules.keys() if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
