"""The Fiat-Shamir coins of StarkWare's two external verifiers (copy of
sandstorm_tpu/crypto/coins.py): the Solidity verifier's (Keccak-256) and
the Cairo verifier's (Blake2s-256), on one shared protocol.

- reseed: digest' = H((digest + 1 as u256 BE) || data), counter reset
- draw bytes: H(digest || counter as u256 BE), counter += 1
- field draw: rejection-sample a 256-bit value < 31 * p, then read it as a
  Montgomery representation (from_montgomery_int): a Stark252 felt whatever
  the modulus asked for; the engine reduces it into a smaller field (F.s)
- queries: u64 BE chunks of successive draws mod the domain size,
  deduplicated and sorted; the Cairo verifier draws them in batches of 4
- proof of work: prefix = H(0x0123456789ABCDED || digest || bits); a nonce
  is valid iff H(prefix || nonce as u64 BE) has >= bits leading zero bits;
  the grind (crypto/grind.py, on the prove's device) returns the smallest
  valid nonce from 1
- the Solidity coin reseeds field elements one at a time in Montgomery
  form; the Cairo coin absorbs a felt list as its Pedersen chain hash
"""

from .grind import grind
from .hashes import (P, PedersenHashFn, blake2s256, from_montgomery_int,
                     keccak256, to_montgomery_bytes)

_POW_PREFIX = 0x0123456789ABCDED


def _leading_zero_bits(digest: bytes) -> int:
    return 256 - int.from_bytes(digest, "big").bit_length()


class _VerifierCoin:
    """The digest + counter protocol over a 256-bit hash."""

    HASH = None          # staticmethod: bytes -> 32 bytes
    GRIND_HASH = None    # crypto/grind.py's name of HASH

    def __init__(self, seed_digest: bytes):
        assert len(seed_digest) == 32
        self.digest = seed_digest
        self.counter = 0

    def reseed_with_bytes(self, data: bytes):
        d = int.from_bytes(self.digest, "big") + 1
        self.digest = self.HASH(d.to_bytes(32, "big") + data)
        self.counter = 0

    def draw_bytes(self) -> bytes:
        out = self.HASH(self.digest + self.counter.to_bytes(32, "big"))
        self.counter += 1
        return out

    def reseed_with_digest(self, digest: bytes):
        self.reseed_with_bytes(digest)

    def reseed_with_int(self, value: int):
        self.reseed_with_bytes(int(value).to_bytes(8, "big"))

    def reseed_with_field_element_vector(self, modulus, elements):
        self.reseed_with_bytes(
            b"".join(to_montgomery_bytes(int(e)) for e in elements))

    def draw_felt(self, modulus: int = P) -> int:
        bound = 31 * P
        while True:
            v = int.from_bytes(self.draw_bytes(), "big")
            if v < bound:
                return from_montgomery_int(v)

    def draw_felts(self, modulus: int, n: int):
        return [self.draw_felt(modulus) for _ in range(n)]

    def _draw_u64s(self, count: int):
        out = []
        while len(out) < count:
            raw = self.draw_bytes()
            out += [int.from_bytes(raw[i:i + 8], "big")
                    for i in range(0, 32, 8)]
        return out[:count]

    def draw_queries(self, num_queries: int, domain_size: int):
        return sorted({v % domain_size
                       for v in self._draw_u64s(num_queries)})

    def _pow_prefix(self, bits: int) -> bytes:
        return self.HASH(_POW_PREFIX.to_bytes(8, "big") + self.digest
                         + bytes([bits]))

    def verify_proof_of_work(self, nonce: int, bits: int) -> bool:
        h = self.HASH(self._pow_prefix(bits) + int(nonce).to_bytes(8, "big"))
        return _leading_zero_bits(h) >= bits

    def grind_proof_of_work(self, bits: int, device) -> int:
        """The smallest valid nonce from 1, ground on `device` (the prove's:
        the kernel on a CUDA device, the plain twin on the CPU)."""
        nonce = grind(self.GRIND_HASH, self._pow_prefix(bits), bits,
                      device=device)
        if not self.verify_proof_of_work(nonce, bits):
            raise RuntimeError(f"the {self.GRIND_HASH} grind returned nonce "
                               f"{nonce}, which fails the host check")
        return nonce


class SolidityVerifierPublicCoin(_VerifierCoin):
    """Keccak-256 coin of StarkWare's Solidity verifier
    (crypto/src/public_coin/solidity.rs)."""

    HASH = staticmethod(keccak256)
    GRIND_HASH = "keccak"

    def reseed_with_field_elements(self, modulus, elements):
        # one reseed per element, in Montgomery form (solidity.rs:66-71)
        for e in elements:
            self.reseed_with_bytes(to_montgomery_bytes(int(e)))


class CairoVerifierPublicCoin(_VerifierCoin):
    """Blake2s-256 coin of StarkWare's Cairo verifier
    (crypto/src/public_coin/cairo.rs)."""

    HASH = staticmethod(blake2s256)
    GRIND_HASH = "blake2s"

    def reseed_with_field_elements(self, modulus, elements):
        # the Pedersen chain hash of the list (cairo.rs:76-80)
        h = PedersenHashFn.hash_elements(int(e) for e in elements)
        self.reseed_with_bytes(int(h).to_bytes(32, "big"))

    # the Cairo verifier absorbs a felt vector as its Pedersen chain
    reseed_with_field_element_vector = reseed_with_field_elements

    def draw_queries(self, num_queries: int, domain_size: int):
        """Sorted distinct positions from u64 draws taken in batches of 4
        (cairo.rs:124-130)."""
        batched = -(-num_queries // 4) * 4
        vals = self._draw_u64s(batched)[:num_queries]
        return sorted({v % domain_size for v in vals})
