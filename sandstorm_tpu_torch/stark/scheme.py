"""Commitment + Fiat-Shamir configuration for the engine: the generic scheme
(Blake2s row and node hashing on the device, the generic Blake2s public
coin).  Port of sandstorm_tpu/stark/scheme.py:GenericScheme; the eth and
cairo schemes are not ported yet."""

from ..merkle import MerkleTree
from .transcript import make_coin as make_generic_coin


class GenericScheme:
    name = "generic"
    # full Blake2s-256 digests: 128-bit collision resistance
    COLLISION_RESISTANCE_BITS = 128

    def make_coin(self, pub, options, trace_len):
        return make_generic_coin(pub, options, trace_len)

    def commit(self, F, lde_cols):
        return MerkleTree.from_matrix_columns(
            [F.to_bytes_words(c) for c in lde_cols])

    def hash_row(self, F, row_felts) -> bytes:
        """The leaf digest of a committed row (host mirror of commit)."""
        return MerkleTree.hash_row_host(
            b"".join(int(v).to_bytes(F.NUM_BYTES, "little")
                     for v in row_felts))

    def verify_row(self, F, root, index, row_felts, path):
        return MerkleTree.verify(root, index, self.hash_row(F, row_felts),
                                 path)


def get_scheme(name_or_scheme):
    if name_or_scheme is None or name_or_scheme == "generic":
        return GenericScheme()
    if isinstance(name_or_scheme, str):
        raise NotImplementedError(
            f"scheme {name_or_scheme!r} is not ported yet (generic only)")
    return name_or_scheme
