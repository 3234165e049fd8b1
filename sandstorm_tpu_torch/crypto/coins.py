"""The Cairo verifier's Fiat-Shamir coin (copy of CairoVerifierPublicCoin
of sandstorm_tpu/crypto/coins.py, with its _VerifierCoin base folded in).

- reseed: digest' = H((digest + 1 as u256 BE) || data), counter reset
- draw bytes: H(digest || counter as u256 BE), counter += 1
- field draw: rejection-sample a 256-bit value < 31 * p, then read it as a
  Montgomery representation (from_montgomery_int)
- queries: u64 BE chunks of successive draws mod the domain size, drawn in
  batches of 4, deduplicated and sorted
- proof of work: prefix = H(0x0123456789ABCDED || digest || bits); a nonce
  is valid iff H(prefix || nonce as u64 BE) has >= bits leading zero bits;
  the grind starts at nonce 1 and returns the smallest valid nonce
- a felt list is absorbed as its Pedersen chain hash
H is Blake2s-256.
"""

from .hashes import P, PedersenHashFn, blake2s256, from_montgomery_int

_POW_PREFIX = 0x0123456789ABCDED


def _leading_zero_bits(digest: bytes) -> int:
    return 256 - int.from_bytes(digest, "big").bit_length()


class CairoVerifierPublicCoin:
    """Blake2s-256 coin of StarkWare's Cairo verifier, over Stark252 only."""

    def __init__(self, seed_digest: bytes):
        assert len(seed_digest) == 32
        self.digest = seed_digest
        self.counter = 0

    def reseed_with_bytes(self, data: bytes):
        d = int.from_bytes(self.digest, "big") + 1
        self.digest = blake2s256(d.to_bytes(32, "big") + data)
        self.counter = 0

    def draw_bytes(self) -> bytes:
        out = blake2s256(self.digest + self.counter.to_bytes(32, "big"))
        self.counter += 1
        return out

    def reseed_with_digest(self, digest: bytes):
        self.reseed_with_bytes(digest)

    def reseed_with_int(self, value: int):
        self.reseed_with_bytes(int(value).to_bytes(8, "big"))

    def reseed_with_field_elements(self, modulus, elements):
        h = PedersenHashFn.hash_elements(int(e) for e in elements)
        self.reseed_with_bytes(int(h).to_bytes(32, "big"))

    # the Cairo verifier absorbs a felt vector as its Pedersen chain
    reseed_with_field_element_vector = reseed_with_field_elements

    def draw_felt(self, modulus: int) -> int:
        assert modulus == P, "the Cairo verifier's coin draws Stark252 felts"
        bound = 31 * P
        while True:
            v = int.from_bytes(self.draw_bytes(), "big")
            if v < bound:
                return from_montgomery_int(v)

    def draw_felts(self, modulus: int, n: int):
        return [self.draw_felt(modulus) for _ in range(n)]

    def draw_queries(self, num_queries: int, domain_size: int):
        """Sorted distinct positions from u64 draws taken in batches of 4."""
        batched = -(-num_queries // 4) * 4
        vals = []
        while len(vals) < batched:
            raw = self.draw_bytes()
            vals += [int.from_bytes(raw[i:i + 8], "big")
                     for i in range(0, 32, 8)]
        return sorted({v % domain_size for v in vals[:num_queries]})

    def _pow_prefix(self, bits: int) -> bytes:
        return blake2s256(_POW_PREFIX.to_bytes(8, "big") + self.digest
                          + bytes([bits]))

    def verify_proof_of_work(self, nonce: int, bits: int) -> bool:
        h = blake2s256(self._pow_prefix(bits) + int(nonce).to_bytes(8, "big"))
        return _leading_zero_bits(h) >= bits

    def grind_proof_of_work(self, bits: int) -> int:
        """Host loop from nonce 1: the smallest valid nonce, the same one the
        JAX package's device grind returns."""
        prefix = self._pow_prefix(bits)
        nonce = 1
        while _leading_zero_bits(
                blake2s256(prefix + nonce.to_bytes(8, "big"))) < bits:
            nonce += 1
        return nonce
