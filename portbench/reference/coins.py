"""The Fiat-Shamir coins of StarkWare's Solidity (Keccak-256) and Cairo
(Blake2s-256) verifiers, as the port's crypto/coins.py defines them, for
replaying a proof's transcript.

- reseed: digest' = H((digest + 1 as u256 BE) || data), counter reset
- draw bytes: H(digest || counter as u256 BE), counter += 1
- field draw: rejection-sample a 256-bit value < 31 * p, read it as a
  Montgomery representation
- queries: u64 BE chunks of successive draws mod the domain size,
  deduplicated and sorted; the Cairo coin draws them in batches of 4
- proof of work: prefix = H(0x0123456789ABCDED || digest || bits); a nonce
  is valid iff H(prefix || nonce as u64 BE) has >= bits leading zero bits
- the Solidity coin reseeds field elements one at a time in Montgomery
  form; the Cairo coin absorbs a felt list as its Pedersen chain hash
"""

from .field import P
from .hashes import (blake2s256, from_montgomery_int, keccak256,
                     pedersen_elements, to_montgomery_bytes)

_POW_PREFIX = 0x0123456789ABCDED


class _Coin:
    HASH = None

    def __init__(self, seed_digest: bytes):
        if len(seed_digest) != 32:
            raise ValueError("a coin's seed is 32 bytes")
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

    def reseed_with_int(self, value: int):
        self.reseed_with_bytes(int(value).to_bytes(8, "big"))

    def draw_felt(self) -> int:
        bound = 31 * P
        while True:
            v = int.from_bytes(self.draw_bytes(), "big")
            if v < bound:
                return from_montgomery_int(v)

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

    def proof_of_work_ok(self, nonce: int, bits: int) -> bool:
        prefix = self.HASH(_POW_PREFIX.to_bytes(8, "big") + self.digest
                           + bytes([bits]))
        h = self.HASH(prefix + int(nonce).to_bytes(8, "big"))
        return 256 - int.from_bytes(h, "big").bit_length() >= bits


class SolidityCoin(_Coin):
    HASH = staticmethod(keccak256)

    def reseed_with_felts(self, elements):
        for e in elements:
            self.reseed_with_bytes(to_montgomery_bytes(int(e)))

    def reseed_with_felt_vector(self, elements):
        self.reseed_with_bytes(
            b"".join(to_montgomery_bytes(int(e)) for e in elements))


class CairoCoin(_Coin):
    HASH = staticmethod(blake2s256)

    def reseed_with_felts(self, elements):
        h = pedersen_elements([int(e) for e in elements])
        self.reseed_with_bytes(int(h).to_bytes(32, "big"))

    reseed_with_felt_vector = reseed_with_felts

    def draw_queries(self, num_queries: int, domain_size: int):
        batched = -(-num_queries // 4) * 4
        vals = self._draw_u64s(batched)[:num_queries]
        return sorted({v % domain_size for v in vals})
