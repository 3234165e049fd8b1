"""Fiat-Shamir public coin of the generic scheme (copy of
sandstorm_tpu/coin.py): seed from the public input, reseed with commitment
digests / field elements, draw field-element challenges by rejection
sampling, draw query positions, grind & verify proof-of-work, all on
Blake2s-256 (the analog of miniSTARK's PublicCoinImpl).

Transcript state is a 32-byte digest; draws use (state || counter) hashing,
so prover and verifier replay identically.
"""

import hashlib


def _blake(data: bytes) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()


class PublicCoin:
    def __init__(self, seed_bytes: bytes):
        self.digest = _blake(seed_bytes)
        self.counter = 0

    # -- reseeding ---------------------------------------------------------

    def reseed_with_digest(self, digest: bytes):
        self.digest = _blake(self.digest + digest)
        self.counter = 0

    def reseed_with_field_elements(self, modulus: int, elements):
        data = b"".join(int(e).to_bytes(32, "big") for e in elements)
        self.reseed_with_digest(_blake(data))

    # the generic coin absorbs a felt vector in one reseed either way
    reseed_with_field_element_vector = reseed_with_field_elements

    def reseed_with_int(self, value: int):
        self.reseed_with_digest(int(value).to_bytes(8, "big"))

    # -- draws -------------------------------------------------------------

    def _next_bytes(self) -> bytes:
        self.counter += 1
        return _blake(self.digest + self.counter.to_bytes(8, "big"))

    def draw_felt(self, modulus: int) -> int:
        """Uniform field element via rejection sampling below k*modulus."""
        bound = (1 << 256) // modulus * modulus
        while True:
            v = int.from_bytes(self._next_bytes(), "big")
            if v < bound:
                return v % modulus

    def draw_felts(self, modulus: int, n: int):
        return [self.draw_felt(modulus) for _ in range(n)]

    def draw_queries(self, num_queries: int, domain_size: int):
        """Distinct sorted query positions in [0, domain_size)."""
        positions = set()
        while len(positions) < min(num_queries, domain_size):
            raw = self._next_bytes()
            for i in range(0, 32, 8):
                positions.add(
                    int.from_bytes(raw[i:i + 8], "big") % domain_size)
                if len(positions) >= num_queries:
                    break
        return sorted(positions)

    # -- proof of work -----------------------------------------------------

    def _pow_ok(self, nonce: int, bits: int) -> bool:
        h = _blake(self.digest + nonce.to_bytes(8, "big"))
        return int.from_bytes(h, "big") >> (256 - bits) == 0

    def grind_proof_of_work(self, bits: int) -> int:
        """Find a nonce whose hash has `bits` leading zero bits.

        Host loop; a device grind kernel takes over for large difficulty
        (the default is 16 bits ~ 65k hashes, cf. cli/src/main.rs:55-56).
        """
        nonce = 0
        while not self._pow_ok(nonce, bits):
            nonce += 1
        return nonce

    def verify_proof_of_work(self, nonce: int, bits: int) -> bool:
        return self._pow_ok(nonce, bits)
