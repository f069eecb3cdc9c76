"""pde_tpu_torch — the PyTorch/CUDA port of ``pde_tpu``.

Same module paths as ``pde_tpu`` (``pde_tpu_torch/models/heston.py`` is the
twin of ``pde_tpu/models/heston.py``, and so on), plain functions on
tensors, and an explicit ``device``/``dtype`` wherever a tensor is made.
Every Pallas kernel of the reference becomes a kernel written by hand for
NVIDIA Hopper (``sm_90a``) under ``csrc/``, built from source at first use.

This package imports ``torch`` and never ``jax``, and nothing of
``pde_tpu``: ``pde_tpu/__init__.py`` imports JAX for every submodule.
Submodules are imported on demand, so importing the package is cheap.
"""

__version__ = "0.1.0"
