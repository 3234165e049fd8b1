"""Commitment + Fiat-Shamir configuration for the engine (port of
sandstorm_tpu/stark/scheme.py):

- GenericScheme: Blake2s row and node hashing on the device, the generic
  Blake2s public coin;
- EthVerifierScheme: the LeafVariant Merkle tree over MaskedKeccak256<20>
  (rows and levels hashed on the device by the Keccak kernel) and the
  Solidity verifier's coin, seeded with the Keccak-256 of the CairoAuxInput
  element stream under the canonical Keccak page hash: the reference's
  EthVerifierClaim;
- CairoVerifierScheme: the friendly Merkle tree (MaskedBlake2s<20> rows and
  low layers, Pedersen over the top N_FRIENDLY_LAYERS) and the Cairo
  verifier's coin, seeded with the Blake2s of the CairoAuxInput element
  stream under the Pedersen page hash: the reference's CairoVerifierClaim.
The eth scheme reads the Montgomery form of a 252-bit felt, so it takes
the 252-bit field only.  The cairo scheme also takes Goldilocks: its trees
read a GL value as the Stark252 felt of the same integer and hash every
merge in the 252-bit field (claims.CairoClaim raises for the other fields).

A scheme provides prewarm(F, device), make_coin(pub, options, trace_len),
commit(F, lde_cols) -> a tree (.root bytes, .plan_paths), hash_row and
verify_row.  Roots and path entries are 32-byte strings; felt digests
serialize big-endian.
"""

from ..aux_input import CairoAuxInput
from ..crypto.coins import (CairoVerifierPublicCoin,
                            SolidityVerifierPublicCoin)
from ..crypto.hashes import (CanonicalKeccak256HashFn, MaskedBlake2sHashFn,
                             MaskedKeccak256HashFn, PedersenHashFn,
                             blake2s256, keccak256)
from ..crypto.merkle_variants import FriendlyMerkleTree, LeafVariantMerkleTree
from ..fields.fp252 import Fp252
from ..hashing.pedersen import prewarm_tables
from ..merkle import FriendlyMerkleTreeFast, MaskedKeccakMerkleTree, MerkleTree
from .transcript import make_coin as make_generic_coin

N_FRIENDLY_LAYERS = 22  # the reference's src/claims.rs:10


class GenericScheme:
    name = "generic"
    # full Blake2s-256 digests: 128-bit collision resistance
    COLLISION_RESISTANCE_BITS = 128

    def prewarm(self, F, device):
        """Nothing to build: the generic scheme has no tables."""

    def make_coin(self, pub, options, trace_len):
        return make_generic_coin(pub, options, trace_len)

    def commit(self, F, lde_cols):
        return MerkleTree.from_matrix_columns(
            [F.to_bytes_words(c) for c in lde_cols])

    def hash_row(self, F, row_felts) -> bytes:
        """The leaf digest of a committed row (host mirror of commit).  An
        element's bytes are F.to_hash_bytes_int where the field defines it:
        a GF(p^3) element hashes as three 8-byte LE coordinates, not as the
        packed int's own bytes."""
        tb = getattr(F, "to_hash_bytes_int",
                     lambda v: int(v).to_bytes(F.NUM_BYTES, "little"))
        return MerkleTree.hash_row_host(b"".join(tb(v) for v in row_felts))

    def verify_row(self, F, root, index, row_felts, path):
        return MerkleTree.verify(root, index, self.hash_row(F, row_felts),
                                 path)


class EthVerifierScheme:
    """LeafVariant(MaskedKeccak256<20>) + the Solidity verifier's coin."""

    name = "eth"
    # 20-byte masked Keccak digests: 80-bit collision resistance
    COLLISION_RESISTANCE_BITS = 80
    H = MaskedKeccak256HashFn(20)

    def prewarm(self, F, device):
        """Nothing to build: Keccak needs no tables."""

    def make_coin(self, pub, options, trace_len):
        # seeded with the Keccak-256 of the canonical public-input element
        # stream (the reference's src/lib.rs:145-156)
        seed = keccak256(
            CairoAuxInput(pub).serialize(CanonicalKeccak256HashFn))
        return SolidityVerifierPublicCoin(seed)

    def commit(self, F, lde_cols):
        return MaskedKeccakMerkleTree.from_mont_word_columns(
            [F.to_mont_be_words(c) for c in lde_cols],
            n_unmasked=self.H.N_UNMASKED)

    def hash_row(self, F, row_felts) -> bytes:
        """Leaf digest (32-byte wire form): the masked Keccak of the row's
        Montgomery felts, or for a single-column tree the canonical felt
        big-endian (verify_row encodes it in Montgomery form to merge)."""
        if len(row_felts) == 1:
            return int(row_felts[0]).to_bytes(32, "big")
        return self.H.hash_elements(row_felts)

    def verify_row(self, F, root, index, row_felts, path):
        return LeafVariantMerkleTree.verify_row(
            self.H, root, index, list(row_felts), list(path))


class CairoVerifierScheme:
    """FriendlyMerkleTree<22, Pedersen> + the Cairo verifier's coin."""

    name = "cairo"
    # min(20-byte masked Blake2s rows and low layers = 80, Pedersen 125)
    COLLISION_RESISTANCE_BITS = 80

    def prewarm(self, F, device):
        """Build the Pedersen walk's table on `device` (on a GPU the 128 MB
        16-bit table) before the prove's arrays land, so that the first
        prove, and not every prove, carries it.  The walk is in the 252-bit
        field whatever F is."""
        prewarm_tables(Fp252, device)

    def make_coin(self, pub, options, trace_len):
        seed = blake2s256(CairoAuxInput(pub).serialize(PedersenHashFn))
        return CairoVerifierPublicCoin(seed)

    def commit(self, F, lde_cols):
        """The tree of the columns' rows on their device.  The row hash
        reads each value as a Stark252 felt in Montgomery form and every
        Pedersen merge is in the 252-bit field, whatever F is."""
        if len(lde_cols) > 1:
            return FriendlyMerkleTreeFast.from_mont_word_columns(
                Fp252, [F.to_stark252_mont_be_words(c) for c in lde_cols],
                N_FRIENDLY_LAYERS)
        return FriendlyMerkleTreeFast.from_canonical_column(
            Fp252, F.to_stark252_canonical(lde_cols[0]))

    def _tag(self, depth, height, single, raw32):
        """A node's mixed-digest tag from its depth: leaves are "low" row
        hashes (felts when single-column); an internal node at depth d
        (root = 0) came from a merge at d, algebraic iff
        d < N_FRIENDLY_LAYERS."""
        if single or (depth < height and depth < N_FRIENDLY_LAYERS):
            return ("high", int.from_bytes(raw32, "big"))
        return ("low", raw32)

    def hash_row(self, F, row_felts) -> bytes:
        """Leaf digest (32-byte wire form): the masked Blake2s row hash, or
        the raw felt big-endian for a single-column (all-algebraic) tree."""
        if len(row_felts) == 1:
            return int(row_felts[0]).to_bytes(32, "big")
        return MaskedBlake2sHashFn(20).hash_elements(row_felts)

    def verify_row(self, F, root, index, row_felts, path):
        height = len(path)
        single = len(row_felts) == 1
        tree = FriendlyMerkleTree(N_FRIENDLY_LAYERS)
        tagged = [self._tag(height - lvl, height, single, sib)
                  for lvl, sib in enumerate(path)]
        troot = self._tag(0, height, single, root)
        return tree.verify_row(troot, index, list(row_felts), tagged)


SCHEMES = {"generic": GenericScheme, "eth": EthVerifierScheme,
           "cairo": CairoVerifierScheme}


def get_scheme(name_or_scheme):
    if name_or_scheme is None:
        return GenericScheme()
    if isinstance(name_or_scheme, str):
        return SCHEMES[name_or_scheme]()
    return name_or_scheme
