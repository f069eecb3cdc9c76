"""Data: options analytics, providers, validation, streaming, ingestion and
reference data (the reference's recovery, monitoring and API modules are
left out of the port)."""

from . import ingestion, options, providers, reference, streaming, validation  # noqa: F401
from .options import OptionsChainProcessor, SVIParameterization, VolatilitySurface  # noqa: F401
