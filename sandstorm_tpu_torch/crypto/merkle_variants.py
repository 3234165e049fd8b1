"""The two verifiers' Merkle trees on the host (copy of
sandstorm_tpu/crypto/merkle_variants.py): the protocols' definitions, which
the verifier and the tests use.

LeafVariantMerkleTree (the eth scheme's, over MaskedKeccak256<20>): the rows
of a matrix of two or more columns are element-hashed first ("Hashed"); a
single-column matrix's leaves are the raw felts ("Unhashed"), which a merge
encodes in Montgomery form.

FriendlyMerkleTree (the cairo scheme's): rows hash with MaskedBlake2s<20>;
a node whose parent sits at depth >= n_friendly (counted from the root)
merges with MaskedBlake2s, the top n_friendly layers merge with Pedersen,
after the boundary Blake digests are read as big-endian felts.  A
single-column tree has felt leaves and merges every level with Pedersen.
Digests are tagged ("high" | "low", value): "low" for byte digests, "high"
for felts.
"""

from .hashes import MaskedBlake2sHashFn, PedersenHashFn, to_montgomery_bytes

_MASKED_BLAKE20 = MaskedBlake2sHashFn(20)


class _HostTree:
    """Plain single-hash binary tree over a list of leaf digests."""

    def __init__(self, leaves, merge_fn):
        n = len(leaves)
        assert n & (n - 1) == 0 and n > 0
        self.levels = [list(leaves)]
        while len(self.levels[-1]) > 1:
            prev = self.levels[-1]
            self.levels.append(
                [merge_fn(prev[i], prev[i + 1]) for i in range(0, len(prev), 2)])

    @property
    def root(self):
        return self.levels[-1][0]

    def prove(self, index: int):
        path, idx = [], index
        for level in self.levels[:-1]:
            path.append(level[idx ^ 1])
            idx >>= 1
        return path

    @staticmethod
    def verify(root, index, leaf, path, merge_fn):
        node, idx = leaf, index
        for sib in path:
            node = merge_fn(sib, node) if idx & 1 else merge_fn(node, sib)
            idx >>= 1
        return node == root


class LeafVariantMerkleTree:
    """Matrix commitment with hashed or unhashed leaves (the reference's
    crypto/src/merkle/mod.rs:240+)."""

    def __init__(self, hash_fn):
        self.H = hash_fn
        self._tree = None
        self.single_col = False

    @classmethod
    def from_rows(cls, hash_fn, rows):
        """rows: per-row felt lists (all of length 1: unhashed leaves)."""
        self = cls(hash_fn)
        if all(len(r) == 1 for r in rows):
            self.single_col = True
            leaves, merge = [r[0] for r in rows], self._unhashed_merge
        else:
            leaves = [hash_fn.hash_elements(r) for r in rows]
            merge = hash_fn.merge
        self._tree = _HostTree(leaves, merge)
        return self

    def _unhashed_merge(self, a, b):
        """A raw-felt leaf serialises in Montgomery form, the byte
        convention of the tree's Keccak (crypto/src/hash/keccak.rs:50-57);
        a digest as it is."""
        return self.H.hash(b"".join(
            to_montgomery_bytes(x) if isinstance(x, int) else x
            for x in (a, b)))

    @property
    def root(self):
        return self._tree.root

    def prove(self, index: int):
        return self._tree.prove(index)

    @classmethod
    def verify_row(cls, hash_fn, root, index, row, path):
        self = cls(hash_fn)
        if len(row) == 1:
            leaf, merge = row[0], self._unhashed_merge
        else:
            leaf, merge = hash_fn.hash_elements(row), hash_fn.merge
        return _HostTree.verify(root, index, leaf, path, merge)


class FriendlyMerkleTree:
    """Mixed-hash tree: Blake2s low layers, Pedersen top layers."""

    def __init__(self, n_friendly_layers: int):
        self.n_friendly = n_friendly_layers
        self.FH = PedersenHashFn
        self.row_hash = _MASKED_BLAKE20
        self.levels = None

    def _merge_at_depth(self, depth: int, a, b):
        """depth = the parent's distance from the root."""
        if depth >= self.n_friendly:
            return ("low", self.row_hash.merge(a[1], b[1]))
        if a[0] == "low":
            return ("high", self.FH.merge(int.from_bytes(a[1], "big"),
                                          int.from_bytes(b[1], "big")))
        return ("high", self.FH.merge(a[1], b[1]))

    @classmethod
    def from_rows(cls, n_friendly_layers, rows):
        self = cls(n_friendly_layers)
        if all(len(r) == 1 for r in rows):
            tree = _HostTree(
                [("high", r[0]) for r in rows],
                lambda a, b: ("high", self.FH.merge(a[1], b[1])))
            self.levels = tree.levels
            return self
        height = max(len(rows).bit_length() - 1, 0)
        self.levels = [[("low", self.row_hash.hash_elements(r))
                        for r in rows]]
        while len(self.levels[-1]) > 1:
            prev = self.levels[-1]
            depth = height - len(self.levels)  # parent depth from root
            self.levels.append([
                self._merge_at_depth(depth, prev[i], prev[i + 1])
                for i in range(0, len(prev), 2)])
        return self

    @property
    def root(self):
        return self.levels[-1][0]

    def prove(self, index: int):
        path, idx = [], index
        for level in self.levels[:-1]:
            path.append(level[idx ^ 1])
            idx >>= 1
        return path

    def verify_row(self, root, index, row, path):
        height = len(path)
        if len(row) == 1:
            node = ("high", row[0])
        else:
            node = ("low", self.row_hash.hash_elements(row))
        idx = index
        for lvl, sib in enumerate(path):
            depth = height - 1 - lvl
            a, b = (sib, node) if idx & 1 else (node, sib)
            if len(row) == 1:
                node = ("high", self.FH.merge(a[1], b[1]))
            else:
                node = self._merge_at_depth(depth, a, b)
            idx >>= 1
        return node == root
