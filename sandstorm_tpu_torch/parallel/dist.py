"""Multi-device proving primitives: the mesh, its exchange, and the
sharded NTT / LDE / row hashing on it (port of
sandstorm_tpu/parallel/dist.py).

The four-step decomposition n = n1 * n2 keeps the butterflies on their
shards and moves data between shards in three exchanges:
    1. rows -> cols, column NTTs (length n1, on each shard)
    2. twiddle by w_n^(k1 * i2) (each shard's columns of the matrix)
    3. cols -> rows, row NTTs (length n2, on each shard)
    4. transpose and exchange to natural-order output shards
A shard's transforms are the port's leaf kernels (ntt_cuda.batched_ntt,
unscaled; the inverse scales by 1/n once at the end) and its twiddle
multiply is the field's (fp252_mul / gl_mul on a card), with every column
of the batch in one exchange.  Within a process an exchange is copies
between the shards' tensors; across processes it is one
torch.distributed.all_to_all_single a call on the mesh's group, each peer
rank's chunks in one buffer.  A gloo group's buffers go through host
memory (the caller named gloo); a NCCL group's stay on the card.

Sharding stops at the transforms (see runtime.py): each function here
takes a sharded array as this process's natural-order shards
(runtime.shard0) or as the full array, and returns this process's shards;
`gather` puts the full array back on one device of every process.
Both run inside a recorder span named "mesh.exchange" (telemetry.span: a
profiler range while a profiler is active), so that a trace
(tools/profile_prove.py --mesh) can tell the exchanges' device time from
the transforms'.
"""

import torch
import torch.distributed as tdist

from .. import _tables, telemetry
from ..fields.scan import prefix_mul
from ..hashing.blake2s import blake2s_words
from ..ntt.ntt import coset_powers, powers_dev
from ..ntt.ntt_cuda import batched_ntt, transform_field
from .runtime import Mesh, shard0

NTT_CALLS = 0   # instrumentation: counts four-step dispatches (tests)


def make_mesh(n_devices: int = None, *, device=None) -> Mesh:
    """A one-process mesh.  With `device`, n_devices shards (default 1) on
    that one device: make_mesh(4, device="cuda:0") is a virtual mesh on one
    card, device="cpu" one for tests.  Without, one shard on each of the
    first n_devices visible CUDA cards (all of them by default); it raises
    where there is no card."""
    if device is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device (name one, e.g. "
                               "device='cpu', for a mesh off the card)")
        n = n_devices or count
        if n > count:
            raise ValueError(f"make_mesh: {n} shards, {count} CUDA devices")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh((dev,) * (n_devices or 1))


def _comm_device(mesh: Mesh, t):
    """Where a cross-process buffer lives: the host for a gloo group, the
    shard's own device otherwise (a NCCL group takes the card's tensors)."""
    if tdist.get_backend(mesh.group) == "gloo":
        return torch.device("cpu")
    return t.device


def _local(x, mesh: Mesh):
    """This process's shards of x: x itself if it is a list of shards, else
    shard0 of the full array."""
    return shard0(x, mesh) if torch.is_tensor(x) else list(x)


def all_to_all(mesh: Mesh, shards, split_dim: int, concat_dim: int):
    """The exchange: shard s's tensor splits along split_dim into D equal
    chunks, chunk d goes to shard d, and shard d concatenates what it gets
    along concat_dim in shard order (jax.lax.all_to_all, tiled)."""
    with telemetry.span("mesh.exchange"):
        return _all_to_all(mesh, shards, split_dim, concat_dim)


def _all_to_all(mesh: Mesh, shards, split_dim: int, concat_dim: int):
    D = mesh.size
    chunks = [s.chunk(D, split_dim) for s in shards]
    if mesh.world == 1:
        return [torch.cat([chunks[s][d].to(dev) for s in range(D)],
                          concat_dim)
                for d, dev in enumerate(mesh.devices)]
    L = mesh.local
    shape = tuple(chunks[0][0].shape)
    comm = _comm_device(mesh, shards[0])
    # [local source, peer rank, local destination, chunk] -> peer-major
    send = torch.stack([torch.stack(c).to(comm) for c in chunks])
    send = send.reshape((L, mesh.world, L) + shape).transpose(0, 1) \
        .contiguous()
    recv = torch.empty_like(send)
    tdist.all_to_all_single(recv, send, group=mesh.group)
    # recv[q, j, jj]: from shard q * L + j to this process's shard jj
    return [torch.cat(list(recv[:, :, jj].reshape((D,) + shape).to(dev)
                           .unbind(0)), concat_dim)
            for jj, dev in enumerate(mesh.devices)]


def gather(shards, mesh: Mesh, device):
    """The full array [n, ...] of this process's natural-order shards on
    `device`, on every process of the mesh (all-gathered across them)."""
    with telemetry.span("mesh.exchange"):
        return _gather(shards, mesh, device)


def _gather(shards, mesh: Mesh, device):
    if mesh.world == 1:
        return torch.cat([s.to(device) for s in shards], 0)
    comm = _comm_device(mesh, shards[0])
    mine = torch.cat([s.to(comm) for s in shards], 0)
    parts = [torch.empty_like(mine) for _ in range(mesh.world)]
    tdist.all_gather(parts, mine, group=mesh.group)
    return torch.cat(parts, 0).to(device)


def _twiddle_shards(T, mesh: Mesh, n1: int, n2: int, inverse: bool):
    """Each local shard's [n1, n2 / D, 1, L] block of the matrix
    w_n^(k1 * i2) (i2 the shard's global columns), built on the shard's
    device from a powers_dev table and cached there (_tables) by field,
    size, direction, D and global shard index."""
    n = n1 * n2
    c = n2 // mesh.size
    first = mesh.rank * mesh.local

    def build(s, dev):
        w = T.root_of_unity_int(n)
        if inverse:
            w = pow(w, -1, T.BASE_MODULUS)
        wp = powers_dev(T, w, n, dev)                    # w^e, e < n
        k1 = torch.arange(n1, dtype=torch.int64, device=dev)
        i2 = s * c + torch.arange(c, dtype=torch.int64, device=dev)
        return wp[(k1[:, None] * i2[None, :]) % n].reshape(n1, c, 1,
                                                           T.NLIMBS)

    return [_tables.device_table(
                f"mesh_twiddle_{T.NAME}_{n1}x{n2}_"
                f"{'inv' if inverse else 'fwd'}_D{mesh.size}_s{first + j}",
                n1 * c, dev, lambda s=first + j, dev=dev: build(s, dev))
            for j, dev in enumerate(mesh.devices)]


def dist_ntt(F, mesh: Mesh, x, inverse: bool = False):
    """NTT along axis 0 of a sharded [n, ..., L] array by the four-step
    method (D | n1 and D | n2); returns this process's natural-order
    shards of the result.  The inverse includes the 1/n scale.  A GF(p^3)
    array transforms as Goldilocks (ntt_cuda.transform_field).  A span
    "mesh.dist_ntt": its time less its "mesh.exchange" spans is the
    python dispatch over the shards."""
    global NTT_CALLS
    NTT_CALLS += 1
    with telemetry.span("mesh.dist_ntt", shards=mesh.size):
        return _dist_ntt(F, mesh, x, inverse)


def _dist_ntt(F, mesh: Mesh, x, inverse: bool):
    shards = _local(x, mesh)
    D = mesh.size
    n = shards[0].shape[0] * D
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    if n & (n - 1) or n1 % D or n2 % D:
        raise ValueError(f"dist_ntt: n = {n} does not split over {D} "
                         f"shards (n1 = {n1}, n2 = {n2})")
    T = transform_field(F)
    rest = tuple(shards[0].shape[1:])
    L = T.NLIMBS
    a = [s.reshape(n1 // D, n2, -1, L) for s in shards]
    B = a[0].shape[2]
    a = all_to_all(mesh, a, 1, 0)                        # [n1, n2 / D, B]
    tw = _twiddle_shards(T, mesh, n1, n2, inverse)
    a = [T.mul(batched_ntt(T, s.reshape(n1, -1, L), inverse)
               .reshape(n1, n2 // D, B, L), t) for s, t in zip(a, tw)]
    a = all_to_all(mesh, a, 0, 1)                        # [n1 / D, n2, B]
    # the row transforms over i2, in the transposed layout [k2, k1]
    a = [batched_ntt(T, s.transpose(0, 1).reshape(n2, -1, L), inverse)
         .reshape(n2, n1 // D, B, L) for s in a]
    a = all_to_all(mesh, a, 0, 1)                        # [n2 / D, n1, B]
    out = [s.reshape((n // D,) + rest) for s in a]
    if inverse:
        n_inv = pow(n, -1, F.BASE_MODULUS)
        out = [F.mul(s, F.encode_int(n_inv, s.device)) for s in out]
    return out


def dist_coset_lde(F, mesh: Mesh, evals, blowup: int, coset: int):
    """Interpolate a sharded [n, ..., L] array and evaluate it on
    {coset * w_N^i}, N = n * blowup: this process's shards of the
    [N, ..., L] result.  The coefficients are gathered once, zero-padded
    and sharded again over the larger domain."""
    shards = _local(evals, mesh)
    n = shards[0].shape[0] * mesh.size
    c = n // mesh.size
    first = mesh.rank * mesh.local
    coeffs = dist_ntt(F, mesh, shards, inverse=True)
    scaled = []
    for j, s in enumerate(coeffs):
        pw = coset_powers(F, coset, n, s.device)[(first + j) * c:
                                                 (first + j + 1) * c]
        scaled.append(F.mul(s, pw.reshape((c,) + (1,) * (s.dim() - 2)
                                          + (F.NLIMBS,))))
    full = gather(scaled, mesh, shards[0].device)
    padded = torch.cat([full, torch.zeros(
        (n * (blowup - 1),) + tuple(full.shape[1:]), dtype=full.dtype,
        device=full.device)], 0)
    return dist_ntt(F, mesh, padded)


def dist_hash_rows(F, mesh: Mesh, cols):
    """Blake2s of each row of the matrix whose sharded [N, L] columns are
    `cols`, where the rows live: this process's shards of [N, 8]."""
    cols = [_local(c, mesh) for c in cols]
    return [blake2s_words(torch.cat([F.to_bytes_words(c[j]) for c in cols],
                                    dim=-1))
            for j in range(mesh.local)]


def dist_prove_step(F, mesh: Mesh, columns, blowup: int = 2,
                    challenge_ints=(3, 5)):
    """One sharded prover macro-step: each trace column's coset LDE, a
    permutation-style running product over the first LDE column (the
    field's prefix_mul on the gathered column: fp252_scan_mul on a card
    for Fp252), then the leaf hashes of the LDEs and the product, sharded:
    this process's shards of the [N, 8] leaves."""
    ldes = [dist_coset_lde(F, mesh, c, blowup, F.GENERATOR) for c in columns]
    dev = ldes[0][0].device
    first = gather(ldes[0], mesh, dev)
    term = F.sub(F.encode_int(challenge_ints[0], dev).expand(first.shape),
                 first)
    cum = prefix_mul(F, term)
    return dist_hash_rows(F, mesh, ldes + [shard0(cum, mesh)])
