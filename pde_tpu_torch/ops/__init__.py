"""Hand-written CUDA kernels with their plain PyTorch twins."""

from . import adi_fused, build, cn1d_fused, cn1d_tv_fused, tridiag  # noqa: F401
