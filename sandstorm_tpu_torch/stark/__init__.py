from .ark import ArkProof, ArkQueries, FriLayer, MerkleView, \
    parse_proof, serialize_proof
from .options import ProofOptions
from .prover import prove
from .verifier import verify, VerificationError

__all__ = [
    "ProofOptions", "ArkProof", "ArkQueries", "FriLayer", "MerkleView",
    "parse_proof", "serialize_proof", "prove", "verify",
    "VerificationError",
]
