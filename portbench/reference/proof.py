"""Parser of the ark-serialized proof (arkworks' CanonicalSerialize,
compressed, of miniSTARK's Proof<Claim>): a frozen copy of the reading
half of sandstorm_tpu_torch/stark/ark.py, whose docstring gives the
byte layout.  A malformed proof raises ProofFormatError."""

import dataclasses
import struct
from typing import List, Optional

P = (1 << 251) + 17 * (1 << 192) + 1


class ProofFormatError(ValueError):
    pass


@dataclasses.dataclass
class MerkleView:
    """One query's authentication data (ministark merkle::MerkleView)."""
    hashed: bool            # enum discriminant: 0 Hashed / 1 Unhashed
    nodes: List[bytes]      # 32-byte sibling digests (path above leaf pair)
    initial_leaf: object    # bytes (Hashed) | int felt (Unhashed)
    sibling_leaf: object


@dataclasses.dataclass
class FriLayer:
    values: List[int]       # row-major query rows (num_queries x fold)
    proofs: List[MerkleView]
    commitment: bytes


@dataclasses.dataclass
class ArkQueries:
    base_values: List[int]
    ext_values: List[int]
    comp_values: List[int]
    base_proofs: List[MerkleView]
    ext_proofs: List[MerkleView]
    comp_proofs: List[MerkleView]


@dataclasses.dataclass
class ArkProof:
    options: tuple          # (queries, blowup, pow_bits, fold, remainder)
    trace_len: int
    base_commitment: bytes
    ext_commitment: Optional[bytes]
    comp_commitment: bytes
    fri_layers: List[FriLayer]
    fri_remainder: List[int]
    pow_nonce: int
    queries: ArkQueries
    execution_ood_evals: List[int]
    composition_ood_evals: List[int]


# -- reading ----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, modulus: int = P):
        self.data = data
        self.pos = 0
        self.modulus = modulus

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def raw(self, k: int) -> bytes:
        v = self.data[self.pos:self.pos + k]
        if len(v) != k:
            raise ProofFormatError("truncated proof")
        self.pos += k
        return v

    def digest(self) -> bytes:
        k = self.u64()
        if k != 32:
            raise ProofFormatError(
                f"unexpected digest length {k} at {self.pos - 8}")
        return self.raw(32)

    def felt(self) -> int:
        v = int.from_bytes(self.raw(32), "little")
        if v >= self.modulus:
            raise ProofFormatError(f"non-canonical felt at {self.pos - 32}")
        return v

    def felts(self) -> List[int]:
        return [self.felt() for _ in range(self.u64())]

    def merkle_view(self) -> MerkleView:
        tag = self.u8()
        if tag not in (0, 1):
            raise ProofFormatError(f"bad merkle proof discriminant {tag}")
        nodes = [self.digest() for _ in range(self.u64())]
        leaf = self.digest if tag == 0 else self.felt
        return MerkleView(tag == 0, nodes, leaf(), leaf())

    def merkle_views(self) -> List[MerkleView]:
        return [self.merkle_view() for _ in range(self.u64())]


def parse_proof(data: bytes, modulus: int = P) -> ArkProof:
    """Parse ark-serialized proof bytes; felts are validated against
    `modulus` (the FULL field order — p^3 for the Goldilocks cubic
    extension), so non-canonical values die here as a parse error, not
    deep inside the verifier."""
    r = _Reader(data, modulus)
    options = tuple(r.u8() for _ in range(5))
    trace_len = r.u64()
    base_c = r.digest()
    ext_c = r.digest() if r.u8() else None
    comp_c = r.digest()
    layers = []
    for _ in range(r.u64()):
        values = r.felts()
        proofs = r.merkle_views()
        commitment = r.digest()
        layers.append(FriLayer(values, proofs, commitment))
    remainder = r.felts()
    pow_nonce = r.u64()
    queries = ArkQueries(
        base_values=r.felts(), ext_values=r.felts(), comp_values=r.felts(),
        base_proofs=r.merkle_views(), ext_proofs=r.merkle_views(),
        comp_proofs=r.merkle_views())
    exe_ood = r.felts()
    comp_ood = r.felts()
    if r.pos != len(data):
        raise ProofFormatError(
            f"trailing bytes: consumed {r.pos} of {len(data)}")
    return ArkProof(options, trace_len, base_c, ext_c, comp_c, layers,
                    remainder, pow_nonce, queries, exe_ood, comp_ood)
