"""The distributed layer on ``torch.distributed`` (the port of
``nonlinearsolve_tpu/parallel``): meshes, ``distributed_solve`` (the
ordinary solve on a DTensor state), the explicit per-shard tier with ring
halo exchanges (the z-sharded 3D stencil on K11), the row-partitioned CSR
matvec with K5 on each shard (``sparse_dist.py``), the global dot and the
weak-scaling reports.  Importing it registers the port's DTensor
sharding rules (``dtensor_rules.py``, ROADMAP C.6)."""

from . import dtensor_rules  # noqa: F401  (registers the rules)

from .mesh import create_mesh, replicated, row_sharding
from .distributed import (distributed_solve, halo_exchange,
                          psum_dot_factory, sharded_laplacian_1d_factory,
                          sharded_rd3d_jvp_factory,
                          sharded_rd3d_jvp_pallas_factory)
from .sparse_dist import build_sharded_csr_plan, make_sharded_csr_matvec
