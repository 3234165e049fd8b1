"""Hash functions of the two external verifiers' protocols (copy of
sandstorm_tpu/crypto/hashes.py).

- Keccak256HashFn hashes felts in Montgomery form, each as 32 big-endian
  bytes (to_montgomery_bytes); CanonicalKeccak256HashFn hashes canonical
  felts.  MaskedKeccak256HashFn(N) zeroes all but the N MOST-significant
  digest bytes, i.e. keeps the first N bytes: the Solidity verifier's
  truncated commitments.
- Blake2sHashFn hashes felts in Montgomery form as Keccak256HashFn does.
  MaskedBlake2sHashFn(N) zeroes all but the N LEAST-significant digest
  bytes, i.e. keeps the last N bytes of the digest.
- PedersenHashFn is the algebraic hash over felts; hash_elements is the
  length-tagged chain.

keccak256 is original Keccak-256 (padding 0x01, not sha3's 0x06), in pure
python: the transcript's and the verifier's hash.  Rows and tree levels
hash on the device (hashing/keccak.py).
"""

import hashlib

from ..fields.fp252_cuda import P

_R = (1 << 256) % P              # Montgomery R of the 4x64-bit limbs
_R_INV = pow(_R, -1, P)


_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offset of lane (x, y) as _ROT[x][y]
_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
_M64 = (1 << 64) - 1


def _rol(v, s):
    return ((v << s) | (v >> (64 - s))) & _M64


def _keccak_f(state):
    """Keccak-f[1600] on state[x][y] 64-bit lanes, in place."""
    for rnd in range(24):
        # theta
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3]
             ^ state[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(state[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y])
                                         & b[(x + 2) % 5][y])
        # iota
        state[0][0] ^= _KECCAK_RC[rnd]
    return state


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (pre-NIST padding 0x01), as Ethereum and StarkWare use."""
    rate = 136
    state = [[0] * 5 for _ in range(5)]
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 \
        else b"\x81"
    for block_start in range(0, len(padded), rate):
        block = padded[block_start:block_start + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i:8 * i + 8], "little")
            state[i % 5][i // 5] ^= lane
        state = _keccak_f(state)
    return b"".join(
        state[i % 5][i // 5].to_bytes(8, "little") for i in range(4))


def blake2s256(data: bytes) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()


def to_montgomery_bytes(v: int) -> bytes:
    """Canonical felt -> its Montgomery representation as 32 BE bytes."""
    return (v * _R % P).to_bytes(32, "big")


def from_montgomery_int(u: int) -> int:
    """256-bit draw -> felt: (u mod p) read as a Montgomery representation."""
    return (u % P) * _R_INV % P


def _mask_keep_most_significant(digest: bytes, n_unmasked: int) -> bytes:
    return digest[:n_unmasked] + b"\x00" * (len(digest) - n_unmasked)


def _mask_keep_least_significant(digest: bytes, n_unmasked: int) -> bytes:
    return b"\x00" * (len(digest) - n_unmasked) + digest[-n_unmasked:]


class Keccak256HashFn:
    @staticmethod
    def hash(data: bytes) -> bytes:
        return keccak256(data)

    @classmethod
    def merge(cls, a: bytes, b: bytes) -> bytes:
        return cls.hash(a + b)

    @classmethod
    def hash_elements(cls, elements) -> bytes:
        return cls.hash(b"".join(to_montgomery_bytes(e) for e in elements))


class CanonicalKeccak256HashFn(Keccak256HashFn):
    @classmethod
    def hash_elements(cls, elements) -> bytes:
        return cls.hash(b"".join(int(e).to_bytes(32, "big") for e in elements))


def MaskedKeccak256HashFn(n_unmasked: int):
    """Keccak-256 keeping the N most-significant (first) digest bytes."""

    class _Masked(Keccak256HashFn):
        N_UNMASKED = n_unmasked

        @staticmethod
        def hash(data: bytes) -> bytes:
            return _mask_keep_most_significant(keccak256(data), n_unmasked)

    return _Masked


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
