"""Plain PyTorch references that decide ``correct``.  They import nothing
of ``pde_tpu_torch`` or ``pde_tpu`` and take only the benchmark's own
inputs; every band, lattice and interpolation they need they work out
again."""
