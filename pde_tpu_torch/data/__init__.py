"""Data: options analytics, providers, streaming and reference data (the
reference's validation, ingestion, recovery, monitoring and API modules
come with ROADMAP A.6f or are left out of the port)."""

from . import options, providers, reference, streaming  # noqa: F401
from .options import OptionsChainProcessor, SVIParameterization, VolatilitySurface  # noqa: F401
