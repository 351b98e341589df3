"""The distributed layer on ``torch.distributed`` (the port of
``nonlinearsolve_tpu/parallel``): meshes, the explicit per-shard tier with
ring halo exchanges (the z-sharded 3D stencil on K11), the global dot and
the weak-scaling report.  ``distributed_solve`` and the row-partitioned CSR
matvec (``sparse_dist.py``) are ROADMAP A.31 and raise when called."""

from .mesh import create_mesh, replicated, row_sharding
from .distributed import (distributed_solve, halo_exchange,
                          psum_dot_factory, sharded_laplacian_1d_factory,
                          sharded_rd3d_jvp_factory,
                          sharded_rd3d_jvp_pallas_factory)


def build_sharded_csr_plan(*args, **kwargs):
    raise NotImplementedError(
        "build_sharded_csr_plan (parallel/sparse_dist.py, K5 per shard) is "
        "ROADMAP A.31")


def make_sharded_csr_matvec(*args, **kwargs):
    raise NotImplementedError(
        "make_sharded_csr_matvec (parallel/sparse_dist.py, K5 per shard) is "
        "ROADMAP A.31")
