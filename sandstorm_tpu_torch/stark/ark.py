"""ark-serialize (CanonicalSerialize) compatible proof byte layout.

A host-only copy of sandstorm_tpu/stark/ark.py: the proof container of the
reference prover (arkworks' `CanonicalSerialize`, compressed, of miniSTARK's
`Proof<Claim>`), recovered byte by byte from a reference proof and pinned by
the JAX package's tests/test_ark_format.py.

Recovered layout (all integers little-endian; `Vec<T>` = u64 length + items;
`Fp` = 32-byte canonical little-endian felt; `Digest` = u64 32 + 32 raw
bytes, arkworks' serialization of `SerdeOutput<H>`):

    Proof {
        options:  5 x u8  (num_queries, lde_blowup_factor,
                           proof_of_work_bits, fri_folding_factor,
                           fri_max_remainder_coeffs)   # ProofOptions::new order
        trace_len: u64
        base_trace_commitment: Digest
        extension_trace_commitment: Option<Digest>     # u8 tag 0/1
        composition_trace_commitment: Digest
        fri_proof: {
            layers: Vec<{
                values: Vec<Fp>,          # num_queries x folding_factor rows
                proofs: Vec<MerkleProof>, # one per deduped query index
                commitment: Digest,
            }>,
            remainder: Vec<Fp>,           # coefficients of the last layer
        }
        pow_nonce: u64
        trace_queries: {
            base_trace_values: Vec<Fp>,   # queries x base columns, row-major
            extension_trace_values: Vec<Fp>,
            composition_trace_values: Vec<Fp>,
            base_trace_proofs: Vec<MerkleProof>,
            extension_trace_proofs: Vec<MerkleProof>,
            composition_trace_proofs: Vec<MerkleProof>,
        }
        execution_trace_ood_evals: Vec<Fp>
        composition_trace_ood_evals: Vec<Fp>
    }

    MerkleProof = u8 discriminant            # 0 = Hashed, 1 = Unhashed
                  (the LeafVariantMerkleTreeProof enum)
                + MerkleView {
                      nodes: Vec<Digest>,    # sibling path above the leaf pair
                      initial_leaf: Leaf,    # Digest when Hashed, Fp when not
                      sibling_leaf: Leaf,
                  }

Observations that pinned the layout: masked-Keccak digests keep their 20
most-significant bytes (12 trailing zero bytes — unmistakable in the hex);
FRI layer proof counts drop 40 -> 38 -> 35 as query indices collapse under
folding; the pow nonce 0x80000000000002be is a rayon `find_any` artifact
(range split at the u64 midpoint, solidity.rs:137-151).
"""

import dataclasses
import io
import struct
from typing import List, Optional

from .. import telemetry

P = (1 << 251) + 17 * (1 << 192) + 1


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
    # the recorder's request of the prove that made it (telemetry)
    request: Optional[int] = dataclasses.field(default=None, compare=False,
                                               repr=False)


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
        assert len(v) == k, "truncated proof"
        self.pos += k
        return v

    def digest(self) -> bytes:
        k = self.u64()
        assert k == 32, f"unexpected digest length {k} at {self.pos - 8}"
        return self.raw(32)

    def felt(self) -> int:
        v = int.from_bytes(self.raw(32), "little")
        assert v < self.modulus, f"non-canonical felt at {self.pos - 32}"
        return v

    def felts(self) -> List[int]:
        return [self.felt() for _ in range(self.u64())]

    def merkle_view(self) -> MerkleView:
        tag = self.u8()
        assert tag in (0, 1), f"bad merkle proof discriminant {tag}"
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
    assert r.pos == len(data), \
        f"trailing bytes: consumed {r.pos} of {len(data)}"
    return ArkProof(options, trace_len, base_c, ext_c, comp_c, layers,
                    remainder, pow_nonce, queries, exe_ood, comp_ood)


# -- writing ----------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.out = io.BytesIO()

    def u8(self, v: int):
        self.out.write(bytes([v]))

    def u64(self, v: int):
        self.out.write(struct.pack("<Q", v))

    def digest(self, d: bytes):
        assert len(d) == 32
        self.u64(32)
        self.out.write(d)

    def felt(self, v: int):
        self.out.write(int(v).to_bytes(32, "little"))

    def felts(self, vals):
        self.u64(len(vals))
        for v in vals:
            self.felt(v)

    def merkle_view(self, mv: MerkleView):
        self.u8(0 if mv.hashed else 1)
        self.u64(len(mv.nodes))
        for nd in mv.nodes:
            self.digest(nd)
        leaf = self.digest if mv.hashed else self.felt
        leaf(mv.initial_leaf)
        leaf(mv.sibling_leaf)

    def merkle_views(self, mvs):
        self.u64(len(mvs))
        for mv in mvs:
            self.merkle_view(mv)


def serialize_proof(p: ArkProof) -> bytes:
    with telemetry.span("serialize", request=p.request):
        return _serialize(p)


def _serialize(p: ArkProof) -> bytes:
    w = _Writer()
    for o in p.options:
        w.u8(o)
    w.u64(p.trace_len)
    w.digest(p.base_commitment)
    if p.ext_commitment is None:
        w.u8(0)
    else:
        w.u8(1)
        w.digest(p.ext_commitment)
    w.digest(p.comp_commitment)
    w.u64(len(p.fri_layers))
    for layer in p.fri_layers:
        w.felts(layer.values)
        w.merkle_views(layer.proofs)
        w.digest(layer.commitment)
    w.felts(p.fri_remainder)
    w.u64(p.pow_nonce)
    q = p.queries
    w.felts(q.base_values)
    w.felts(q.ext_values)
    w.felts(q.comp_values)
    w.merkle_views(q.base_proofs)
    w.merkle_views(q.ext_proofs)
    w.merkle_views(q.comp_proofs)
    w.felts(p.execution_ood_evals)
    w.felts(p.composition_ood_evals)
    return w.out.getvalue()
