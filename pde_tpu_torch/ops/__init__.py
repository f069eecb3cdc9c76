"""Hand-written CUDA kernels with their plain PyTorch twins."""

from . import adi_fused, build  # noqa: F401
