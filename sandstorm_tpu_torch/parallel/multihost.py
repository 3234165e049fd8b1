"""Multi-process runtime: torch.distributed wiring for proving over the
cards of several processes or hosts (port of
sandstorm_tpu/parallel/multihost.py).

One python process runs per card; `initialize()` joins them into one
process group, after which `global_mesh()` spans every process's shards
and `prove(mesh=...)` runs its transforms' exchanges over the group
(NCCL between cards; gloo, through host memory, when the caller names
it).  Every process executes the same `prove()` call and holds the same
proof bytes.

Typical launch, one process a card (torchrun sets MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK):

    torchrun --nproc-per-node 4 prove_script.py

    from sandstorm_tpu_torch.parallel import multihost
    multihost.initialize()
    mesh = multihost.global_mesh()
    proof = claim.prove(witness, options, mesh=mesh)

Elsewhere pass coordinator_address (tcp://host:port or file:///path),
num_processes and process_id.
"""

import os

import torch
import torch.distributed as tdist

from .runtime import Mesh

_INITIALIZED = False


def initialize(coordinator_address: str = None, num_processes: int = None,
               process_id: int = None, *, backend: str = None) -> None:
    """Join this process to the process group (idempotent).

    The arguments default to torchrun's MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK; with none of them this is a one-process run and
    nothing is joined.  The backend defaults to NCCL where CUDA is present
    and gloo otherwise; the caller may name gloo on a card (its exchanges
    then pass through host memory).  A NCCL process takes the card
    LOCAL_RANK names (default: its rank modulo the visible cards)."""
    global _INITIALIZED
    if _INITIALIZED or tdist.is_initialized():
        _INITIALIZED = True
        return
    env = os.environ
    if coordinator_address:
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world = int(num_processes if num_processes is not None
                    else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
    elif env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        init = "env://"
        world = int(num_processes if num_processes is not None
                    else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
    else:
        # nothing to join: the same calling code runs in one process
        _INITIALIZED = True
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank))
    tdist.init_process_group(backend, init_method=init, world_size=world,
                             rank=rank)
    _INITIALIZED = True


def _local_rank(rank: int = None) -> int:
    """This process's card: LOCAL_RANK, else its rank modulo the visible
    cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_grid()[0] if rank is None else rank
    return rank % max(1, torch.cuda.device_count())


def global_mesh(n_local: int = None, *, device=None) -> Mesh:
    """A one-axis mesh over every process's shards: this process's are
    n_local shards (default 1) on `device` (default its card,
    cuda:LOCAL_RANK).  In a one-process run it is make_mesh(n_local,
    device=device): with no device, every visible card."""
    rank, world = process_grid()
    if world == 1:
        from .dist import make_mesh
        return make_mesh(n_local, device=device)
    dev = torch.device("cuda", _local_rank()) if device is None \
        else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank())
    return Mesh((dev,) * (n_local or 1), group=tdist.group.WORLD, rank=rank,
                world=world)


def is_coordinator() -> bool:
    return process_grid()[0] == 0


def process_grid() -> tuple:
    """(rank, world size) of this process."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1
