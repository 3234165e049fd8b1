"""Multi-device proving: the mesh, the four-step exchange NTT and the
multi-process runtime (port of sandstorm_tpu/parallel)."""

from . import dist, multihost, runtime
from .dist import (dist_coset_lde, dist_hash_rows, dist_ntt,
                   dist_prove_step, make_mesh)
from .runtime import active_mesh, mesh_scope, shard0

__all__ = ["dist", "multihost", "runtime", "make_mesh", "dist_ntt",
           "dist_coset_lde", "dist_hash_rows", "dist_prove_step",
           "active_mesh", "mesh_scope", "shard0"]
