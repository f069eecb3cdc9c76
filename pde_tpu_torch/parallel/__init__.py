"""Device mesh, process groups and the multi-rank calibration, PDE and
Monte Carlo paths on ``torch.distributed`` (twin of ``pde_tpu/parallel``).

One process a device; the ranks form a ``DeviceMesh`` whose dimension
names are the reference's axis names (``dp``, ``quotes``, ``grid``).  NCCL
carries a mesh of cards, gloo a mesh of CPU ranks.  ``comm_audit`` counts
the collectives the sharded programs call as they run.
"""

from . import mesh  # noqa: F401
from .mesh import (initialize_distributed, make_mesh, psum, sharded_calibration_step,  # noqa: F401
                   using_mesh)
from . import halo  # noqa: F401
from . import dist_tridiag  # noqa: F401
from .dist_tridiag import dist_tridiagonal_solve, partitioned_thomas_spmd  # noqa: F401
from . import adi_sharded  # noqa: F401
from .adi_sharded import sharded_bs_solve, sharded_heston_solve  # noqa: F401
from . import comm_audit  # noqa: F401
from .comm_audit import collective_counts  # noqa: F401
from . import mc  # noqa: F401
from .mc import price_american_lsm_sharded, price_european_mc_sharded  # noqa: F401
