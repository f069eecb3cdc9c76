"""Data pipeline: options analytics, providers, validation, streaming,
ingestion, reference data, recovery, data-quality monitoring, storage,
alternative data and the market-data HTTP service.

``recovery`` and ``monitoring`` are imported with the reference's guard:
a module that cannot import is left out, not an error.  ``api`` needs
``aiohttp`` at import, which a host may not have, so it is imported when
it is first asked for (``pde_tpu_torch.data.api``), never with the
package.
"""

import importlib

from . import ingestion, options, providers, reference, streaming, validation  # noqa: F401
from .options import OptionsChainProcessor, SVIParameterization, VolatilitySurface  # noqa: F401

for _name in ("recovery", "monitoring"):
    try:
        __import__(f"{__name__}.{_name}")
    except ImportError:  # pragma: no cover
        pass
del _name


def __getattr__(name):
    if name == "api":
        return importlib.import_module(f"{__name__}.api")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
