"""Hash functions of the Cairo-verifier protocol (copy of the parts of
sandstorm_tpu/crypto/hashes.py that the cairo scheme uses; the Keccak
functions come with the eth scheme).

- Blake2sHashFn hashes felts in Montgomery form, each as 32 big-endian
  bytes (to_montgomery_bytes).
- MaskedBlake2sHashFn(N) zeroes all but the N LEAST-significant digest
  bytes, i.e. keeps the last N bytes of the digest.
- PedersenHashFn is the algebraic hash over felts; hash_elements is the
  length-tagged chain.
"""

import hashlib

from ..fields.fp252_cuda import P

_R = (1 << 256) % P              # Montgomery R of the 4x64-bit limbs
_R_INV = pow(_R, -1, P)


def blake2s256(data: bytes) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()


def to_montgomery_bytes(v: int) -> bytes:
    """Canonical felt -> its Montgomery representation as 32 BE bytes."""
    return (v * _R % P).to_bytes(32, "big")


def from_montgomery_int(u: int) -> int:
    """256-bit draw -> felt: (u mod p) read as a Montgomery representation."""
    return (u % P) * _R_INV % P


def _mask_keep_least_significant(digest: bytes, n_unmasked: int) -> bytes:
    return b"\x00" * (len(digest) - n_unmasked) + digest[-n_unmasked:]


class Blake2sHashFn:
    @staticmethod
    def hash(data: bytes) -> bytes:
        return blake2s256(data)

    @classmethod
    def merge(cls, a: bytes, b: bytes) -> bytes:
        return cls.hash(a + b)

    @classmethod
    def hash_elements(cls, elements) -> bytes:
        return cls.hash(b"".join(to_montgomery_bytes(e) for e in elements))


def MaskedBlake2sHashFn(n_unmasked: int):
    """Blake2s keeping the N least-significant (last) digest bytes."""

    class _Masked(Blake2sHashFn):
        @staticmethod
        def hash(data: bytes) -> bytes:
            return _mask_keep_least_significant(blake2s256(data), n_unmasked)

    return _Masked


class PedersenHashFn:
    """Algebraic (recursive-verifier-friendly) hash over felts."""

    @staticmethod
    def merge(a: int, b: int) -> int:
        from ..builtins.pedersen import pedersen_hash
        return pedersen_hash(a, b)

    @staticmethod
    def hash_elements(elements) -> int:
        """h(...h(h(0, e0), e1)..., count): the chain with a length tag."""
        from ..builtins.pedersen import pedersen_hash
        curr, count = 0, 0
        for v in elements:
            curr = pedersen_hash(curr, int(v))
            count += 1
        return pedersen_hash(curr, count)
