"""Proof options.

Parity with ministark's ProofOptions::new(num_queries, lde_blowup_factor,
proof_of_work_bits, fri_folding_factor, fri_max_remainder_coeffs); defaults
match the reference CLI (cli/src/main.rs:45-61).
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ProofOptions:
    num_queries: int = 65
    lde_blowup_factor: int = 2
    proof_of_work_bits: int = 16
    fri_folding_factor: int = 8
    fri_max_remainder_coeffs: int = 16

    def to_bytes(self) -> bytes:
        return b"".join(
            int(v).to_bytes(4, "big")
            for v in (self.num_queries, self.lde_blowup_factor,
                      self.proof_of_work_bits, self.fri_folding_factor,
                      self.fri_max_remainder_coeffs))

    def security_level_bits(self, field_bits: int = None,
                            collision_resistance_bits: int = None) -> int:
        """Conjectured security, mirroring ministark's
        Proof::security_level_bits (used by the reference CLI,
        cli/src/main.rs:203): the FRI/query term
        num_queries * log2(blowup) + pow_bits, capped by the field size
        (a uniformly random field element collides with probability 1/|F|)
        and by the commitment hash's collision resistance — without the
        caps the formula over-reports, e.g. 65 queries at blowup 2 under a
        20-byte masked digest is 80-bit, not 81-bit, secure."""
        import math
        bits = int(self.num_queries * math.log2(self.lde_blowup_factor)
                   + self.proof_of_work_bits)
        if field_bits is not None:
            bits = min(bits, field_bits)
        if collision_resistance_bits is not None:
            bits = min(bits, collision_resistance_bits)
        return bits
