"""Blake2s Merkle commitments over matrix rows, hashed on the device.

Port of the generic tree of sandstorm_tpu/merkle.py (MerkleTree, FetchPlan,
the sibling gather).  The levels stay on the device; query paths for every
tree of a query phase are gathered on the device and fetched to the host in
one copy (FetchPlan).
"""

import numpy as np
import torch

from .hashing.blake2s import blake2s_host, hash_node_pairs, hash_rows


def _sibling_stack_dev(levels, indices):
    """[nlevels, Q, 8] sibling digests of the queries, gathered on the
    device (levels: list of [M_l, 8], leaves first)."""
    cur = torch.as_tensor(list(indices), dtype=torch.int64,
                          device=levels[0].device)
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
        host = torch.cat(self._arrays).cpu().numpy().view(np.uint32)
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


class MerkleTree:
    """Binary Merkle tree over [N, 8] leaf digests (N a power of two)."""

    def __init__(self, leaf_digests):
        n = leaf_digests.shape[0]
        assert n & (n - 1) == 0, "leaf count must be a power of two"
        levels = [leaf_digests]
        while levels[-1].shape[0] > 1:
            levels.append(hash_node_pairs(levels[-1]))
        self._levels = levels  # device tensors, leaves first

    @classmethod
    def from_matrix_columns(cls, word_arrays):
        """word_arrays: list of [N, W] canonical-LE word tensors."""
        return cls(hash_rows(word_arrays))

    @property
    def root(self) -> bytes:
        return self._levels[-1][0].cpu().numpy().astype("<u4").tobytes()

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
