"""Data: the options analytics (the reference's providers, validation,
streaming, ingestion, reference data, recovery, monitoring and API modules
are pure Python and are left out of the port)."""

from . import options  # noqa: F401
from .options import OptionsChainProcessor, SVIParameterization, VolatilitySurface  # noqa: F401
