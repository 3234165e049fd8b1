"""The active mesh: routes the port's transforms to the four-step exchange
NTT (parallel/dist.py) without threading a mesh through every call site
(port of sandstorm_tpu/parallel/runtime.py).

`prove(mesh=...)` opens a `mesh_scope`; inside it `ntt()` sends every
transform whose split n = n1 * n2 the mesh divides (`four_step_ok`) to
`dist.dist_ntt` and gathers the result back to the input's device (on
every process of a multi-process mesh).  Sharding stops at the
transforms: torch has no sharding propagation, so the rest of the prove
runs on the claim's device as it does without a mesh.  The transforms
give the same field elements as the single-device ones, so a proof under
a mesh is the same bytes.

A Mesh is this process's shard devices (a torch device may repeat: four
shards on one card are a virtual mesh, as the JAX package's tests force
eight CPU devices), an optional torch.distributed process group that
joins several processes' shards, and its size D = local shards x world
size.  Shards are numbered host-major, as jax.devices() orders them:
process r's local shard j is shard r * local + j.
"""

import contextlib
import dataclasses

import torch

_ACTIVE = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices: this process's shard devices; group: the process group
    joining `world` processes (None for a one-process mesh); rank: this
    process's place in it."""
    devices: tuple
    group: object = None
    rank: int = 0
    world: int = 1

    @property
    def local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.local * self.world


def active_mesh():
    return _ACTIVE


@contextlib.contextmanager
def mesh_scope(mesh: Mesh):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def shard0(x, mesh: Mesh = None):
    """This process's natural-order row chunks of x [n, ...] (the same full
    array on every process), one on each of its shard devices: shard g
    holds rows [g n / D, (g + 1) n / D).  Returns x itself without a
    mesh."""
    mesh = mesh or _ACTIVE
    if mesh is None:
        return x
    D = mesh.size
    n = x.shape[0]
    if n % D:
        raise ValueError(f"shard0: {n} rows over {D} shards")
    c = n // D
    first = mesh.rank * mesh.local
    return [x[(first + j) * c:(first + j + 1) * c].to(d)
            for j, d in enumerate(mesh.devices)]


def four_step_ok(n: int, mesh: Mesh = None) -> bool:
    """The four-step split n = n1*n2 needs D | n1 and D | n2."""
    mesh = mesh or _ACTIVE
    if mesh is None:
        return False
    D = mesh.size
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    return n1 % D == 0 and n2 % D == 0
