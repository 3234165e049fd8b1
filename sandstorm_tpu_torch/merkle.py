"""Merkle commitments over matrix rows, hashed on the device.

Port of sandstorm_tpu/merkle.py: the generic Blake2s tree (MerkleTree), the
eth scheme's masked Keccak tree (MaskedKeccakMerkleTree), the cairo
scheme's friendly tree (FriendlyMerkleTreeFast), FetchPlan and the sibling
gather.  The levels stay on the device; query paths for every tree
of a query phase are gathered on the device and fetched to the host in one
copy (FetchPlan).
"""

import numpy as np
import torch

from . import telemetry
from .hashing.blake2s import blake2s_host, hash_node_pairs, hash_rows
from .hashing.keccak import keccak_hash_node_pairs, keccak_hash_rows
from .hashing.pedersen import digest_words_to_canon, hash_pairs
from .native import pedersen_hash_pairs


def _sibling_stack_dev(levels, indices):
    """[nlevels, Q, 8] sibling digests of the queries, gathered on the
    device (levels: list of [M_l, 8], leaves first)."""
    cur = telemetry.to_device(np.array(list(indices), dtype=np.int64),
                              levels[0].device, "query_index")
    out = []
    for level in levels:
        out.append(level[cur ^ 1])
        cur = cur >> 1
    return torch.stack(out)


class FetchPlan:
    """Batches many small device->host reads into one copy: add() queues an
    int32 tensor and returns a handle, run() copies everything at once and
    returns the numpy arrays (as uint32) in handle order."""

    def __init__(self):
        self._arrays = []
        self._shapes = []

    def add(self, arr):
        assert arr.dtype == torch.int32, arr.dtype
        self._arrays.append(arr.reshape(-1))
        self._shapes.append(tuple(arr.shape))
        return len(self._arrays) - 1

    def run(self):
        if not self._arrays:
            return []
        host = telemetry.to_host(torch.cat(self._arrays), "queries") \
            .numpy().view(np.uint32)
        out, off = [], 0
        for sh in self._shapes:
            size = int(np.prod(sh)) if sh else 1
            out.append(host[off:off + size].reshape(sh))
            off += size
        return out


def _digest_paths_np(sibs, nq):
    """[nlev, Q, 8] numpy sibling words -> per-query 32-byte path lists."""
    return [[sibs[l, qi].astype("<u4").tobytes() for l in range(sibs.shape[0])]
            for qi in range(nq)]


class _LevelTree:
    """A binary tree kept as device levels of [M, 8] words, leaves first
    (self._levels): its root and its query paths."""

    @property
    def root(self) -> bytes:
        return telemetry.to_host(self._levels[-1][0], "root").numpy() \
            .astype("<u4").tobytes()

    def prove_batch(self, indices):
        plan = FetchPlan()
        finish = self.plan_paths(indices, plan)
        return finish(plan.run())

    def plan_paths(self, indices, plan: FetchPlan):
        """Queue this tree's sibling gather on `plan`; returns
        finish(results) -> per-query paths (32-byte siblings, leaf->root)."""
        levels = self._levels[:-1]
        nq = len(list(indices))
        if not levels:
            return lambda res: [[] for _ in range(nq)]
        h = plan.add(_sibling_stack_dev(levels, indices))
        return lambda res: _digest_paths_np(res[h], nq)


class MerkleTree(_LevelTree):
    """Binary Merkle tree over [N, 8] leaf digests (N a power of two)."""

    def __init__(self, leaf_digests):
        n = leaf_digests.shape[0]
        assert n & (n - 1) == 0, "leaf count must be a power of two"
        levels = [leaf_digests]
        with telemetry.span("merkle.blake_levels"):
            while levels[-1].shape[0] > 1:
                levels.append(hash_node_pairs(levels[-1]))
        self._levels = levels  # device tensors, leaves first

    @classmethod
    def from_matrix_columns(cls, word_arrays):
        """word_arrays: list of [N, W] canonical-LE word tensors."""
        with telemetry.span("merkle.rows", cols=len(word_arrays)):
            leaves = hash_rows(word_arrays)
        return cls(leaves)

    @staticmethod
    def verify(root: bytes, index: int, leaf_digest: bytes, path) -> bool:
        node = leaf_digest
        idx = index
        for sib in path:
            node = blake2s_host(sib + node) if idx & 1 \
                else blake2s_host(node + sib)
            idx >>= 1
        return node == root

    @staticmethod
    def hash_row_host(row_words_le: bytes) -> bytes:
        """Host mirror of the device leaf hash (input: canonical LE bytes)."""
        return blake2s_host(row_words_le)


class MaskedKeccakMerkleTree(_LevelTree):
    """The eth scheme's LeafVariant tree over MaskedKeccak256<n_unmasked>
    (crypto/merkle_variants.LeafVariantMerkleTree) with its rows and levels
    hashed on the tensors' device (port of
    sandstorm_tpu/merkle.py:MaskedKeccakMerkleTree).

    Rows hash over the Montgomery big-endian felt stream; a digest keeps its
    first n_unmasked bytes (LE words 0 .. n_unmasked / 4 - 1), which the
    kernel writes with the rest zeroed.  A single-column matrix commits its
    felts unhashed: its leaf level is the raw Montgomery big-endian words,
    not masked, and every level above is the masked hash of two children."""

    def __init__(self, levels, single_col: bool):
        self._levels = levels  # device tensors, leaves first
        self.single_col = single_col

    @classmethod
    def from_mont_word_columns(cls, word_cols, n_unmasked: int = 20):
        """word_cols: [N, 8] Montgomery big-endian word tensors
        (Fp252.to_mont_be_words), one a column."""
        if n_unmasked % 4:
            raise ValueError(f"a mask of {n_unmasked} bytes is not whole "
                             f"words")
        keep = n_unmasked // 4
        single = len(word_cols) == 1
        with telemetry.span("merkle.rows", cols=len(word_cols)):
            leaves = word_cols[0] if single \
                else keccak_hash_rows(word_cols, keep)
        levels = [leaves]
        with telemetry.span("merkle.keccak_levels"):
            while levels[-1].shape[0] > 1:
                levels.append(keccak_hash_node_pairs(levels[-1], keep))
        return cls(levels, single)


# levels with at least this many pairs hash on the tensor's device
# (hashing/pedersen.py); smaller ones go to the host C++ batch, where a
# launch per level would cost more than the hashes.  The value is the JAX
# package's crossover on a TPU.  On an H100 the card's route is the faster
# one from 2^7 pairs (chip_smoke.py phase 3e times both routes per level;
# PERF.md keeps the numbers), so this sends two levels per tree to the
# slower route there.
DEVICE_PEDERSEN_MIN_PAIRS = 1 << 9

# MaskedBlake2s<20>: a digest keeps its last 20 bytes, i.e. LE words 3..7
_MASKED_WORDS = 3


def _limbs_u64(t):
    """Canonical [M, 8] int32 limbs (any device) -> numpy [M, 4] LE u64."""
    return np.ascontiguousarray(
        telemetry.to_host(t, "felt_level").numpy()).view("<u8")


def _masked_blake(d):
    d[:, :_MASKED_WORDS] = 0
    return d


class FriendlyMerkleTreeFast:
    """The friendly Merkle tree (crypto/merkle_variants.FriendlyMerkleTree)
    with its rows and big levels hashed on the tensors' device (port of
    sandstorm_tpu/merkle.py:FriendlyMerkleTreeFast).

    Rows hash with MaskedBlake2s<20> over the Montgomery big-endian felt
    stream; merges below depth n_friendly use MaskedBlake2s, the top
    n_friendly layers Pedersen, after the boundary digests are read as
    big-endian felts.  Levels of at least DEVICE_PEDERSEN_MIN_PAIRS pairs go
    through hashing.pedersen.hash_pairs, the rest through the host batch.

    _blake_levels: device [M, 8] digest words, leaves first;
    _felt_dev: device [M, 8] canonical felt levels (when the device hashed
      any), the last of them repeated as _felt_levels[0];
    _felt_levels: numpy [M, 4] u64 felt levels up to the root."""

    def __init__(self, blake_levels, felt_dev_levels, felt_levels):
        self._blake_levels = blake_levels
        self._felt_dev = felt_dev_levels
        self._felt_levels = felt_levels

    @staticmethod
    def _felt_levels_from(F, cur):
        """Pedersen levels above the canonical [M, 8] felt level `cur`."""
        felt_dev = []
        if cur.shape[0] >= 2 * DEVICE_PEDERSEN_MIN_PAIRS:
            felt_dev.append(cur)
            with telemetry.span("merkle.pedersen_device"):
                while cur.shape[0] // 2 >= DEVICE_PEDERSEN_MIN_PAIRS:
                    cur = hash_pairs(F, cur[0::2], cur[1::2])
                    felt_dev.append(cur)
        felt_levels = [_limbs_u64(cur)]
        with telemetry.span("merkle.pedersen_host"):
            while felt_levels[-1].shape[0] > 1:
                prev = felt_levels[-1]
                felt_levels.append(pedersen_hash_pairs(prev[0::2],
                                                       prev[1::2]))
        return felt_dev, felt_levels

    @classmethod
    def from_canonical_column(cls, F, felts):
        """Single-column commitment of [N, 8] canonical Stark252 felts
        (F.to_stark252_canonical of the committed column): the leaves are
        the felts themselves, every merge is Pedersen."""
        return cls([], *cls._felt_levels_from(F, felts))

    @classmethod
    def from_mont_word_columns(cls, F, word_cols, n_friendly: int):
        """Multi-column commitment of [N, 8] Montgomery big-endian word
        columns (F.to_stark252_mont_be_words of each committed column)."""
        if len(word_cols) < 2:
            raise ValueError("from_mont_word_columns takes two or more "
                             "columns; one column is from_canonical_column")
        with telemetry.span("merkle.rows", cols=len(word_cols)):
            blake_levels = [_masked_blake(hash_rows(word_cols))]
        height = blake_levels[0].shape[0].bit_length() - 1
        with telemetry.span("merkle.blake_levels"):
            for _ in range(max(height - n_friendly, 0)):
                blake_levels.append(
                    _masked_blake(hash_node_pairs(blake_levels[-1])))
            felts = digest_words_to_canon(blake_levels[-1])
        return cls(blake_levels, *cls._felt_levels_from(F, felts))

    @property
    def root(self) -> bytes:
        return self._felt_levels[-1][0].tobytes()[::-1]

    def prove_batch(self, indices):
        plan = FetchPlan()
        finish = self.plan_paths(indices, plan)
        return finish(plan.run())

    def plan_paths(self, indices, plan: FetchPlan):
        """Queue the device sibling gathers on `plan`; returns finish(results)
        -> per-query paths of 32-byte siblings, leaf to root.  The last Blake
        level and felt level 0 are one tree level (a conversion, not a
        merge), and a felt serializes big-endian, which for a boundary felt
        is the digest's own bytes; so every sibling serializes the same way.
        Device siblings come from _felt_dev[:-1], host ones from
        _felt_levels[:-1]."""
        idx = [int(i) for i in indices]
        bl = self._blake_levels[:-1]
        hb = plan.add(_sibling_stack_dev(bl, idx)) if bl else None
        cur0 = [q >> len(bl) for q in idx]
        dev = self._felt_dev[:-1]
        hf = plan.add(_sibling_stack_dev(dev, cur0)) if dev else None

        def finish(res):
            paths = (_digest_paths_np(res[hb], len(idx)) if hb is not None
                     else [[] for _ in idx])
            cur = list(cur0)
            if hf is not None:
                for lvl in res[hf]:                       # [Q, 8] u32
                    for q in range(len(idx)):
                        paths[q].append(lvl[q].astype("<u4").tobytes()[::-1])
                cur = [q >> len(dev) for q in cur]
            for level in self._felt_levels[:-1]:
                for q in range(len(idx)):
                    paths[q].append(level[cur[q] ^ 1].tobytes()[::-1])
                cur = [q >> 1 for q in cur]
            return paths
        return finish
