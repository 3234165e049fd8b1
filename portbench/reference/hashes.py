"""The hashes of the two external verifiers' protocols, as the port's
crypto/hashes.py defines them: Keccak-256 (pre-NIST padding) and Blake2s-256
over felts in Montgomery form (32 big-endian bytes each), the masked
20-byte digests of the Merkle trees (Keccak keeps the first 20 bytes,
Blake2s the last 20), and the Pedersen chain.

keccak256_many hashes a batch of equal-length messages at once with NumPy
over uint64 lanes: the verifier hashes every query's path one level at a
time, so the python cost is per level and not per node.
"""

import hashlib

import numpy as np

from .field import P
from .pedersen import hash_chain

_R = (1 << 256) % P              # Montgomery R of the 4x64-bit limbs
_R_INV = pow(_R, -1, P)

_KECCAK_RC = np.array([
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
], dtype=np.uint64)
# rotation offset of lane (x, y) as _ROT[x][y]
_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
_RATE = 136


def _rol(v, s):
    if s == 0:
        return v
    return (v << np.uint64(s)) | (v >> np.uint64(64 - s))


def _keccak_f(a):
    """Keccak-f[1600] over a[x][y]: lists of 5 x 5 uint64 arrays [B]."""
    for rnd in range(24):
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        b = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y] ^ d[x], _ROT[x][y])
        a = [[b[x][y] ^ (~b[(x + 1) % 5][y] & b[(x + 2) % 5][y])
              for y in range(5)] for x in range(5)]
        a[0][0] = a[0][0] ^ _KECCAK_RC[rnd]
    return a


def keccak256_many(msgs):
    """Keccak-256 of each of a list of messages of one length."""
    if not msgs:
        return []
    length = len(msgs[0])
    if any(len(m) != length for m in msgs):
        raise ValueError("keccak256_many takes messages of one length")
    pad_len = _RATE - length % _RATE
    pad = (b"\x01" + b"\x00" * (pad_len - 2) + b"\x80") if pad_len >= 2 \
        else b"\x81"
    data = np.frombuffer(b"".join(m + pad for m in msgs), dtype="<u8")
    lanes = data.reshape(len(msgs), -1).T          # [words, B]
    zero = np.zeros(len(msgs), dtype=np.uint64)
    a = [[zero] * 5 for _ in range(5)]
    for blk in range(0, lanes.shape[0], _RATE // 8):
        for i in range(_RATE // 8):
            a[i % 5][i // 5] = a[i % 5][i // 5] ^ lanes[blk + i]
        a = _keccak_f(a)
    out = np.stack([a[i % 5][i // 5] for i in range(4)], axis=1)
    raw = out.astype("<u8").tobytes()
    return [raw[32 * k:32 * k + 32] for k in range(len(msgs))]


_M64 = (1 << 64) - 1
_RC_INT = [int(v) for v in _KECCAK_RC]


def _rol_int(v, s):
    return ((v << s) | (v >> (64 - s))) & _M64


def _keccak_f_int(state):
    """Keccak-f[1600] on state[x][y] python-int lanes (one message)."""
    for rnd in range(24):
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3]
             ^ state[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol_int(c[(x + 1) % 5], 1) for x in range(5)]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol_int(state[x][y] ^ d[x],
                                                     _ROT[x][y])
        state = [[b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
                  for y in range(5)] for x in range(5)]
        state[0][0] ^= _RC_INT[rnd]
    return state


def keccak256(data: bytes) -> bytes:
    """Keccak-256 of one message in python ints (the coin's draws, one
    after another)."""
    state = [[0] * 5 for _ in range(5)]
    pad_len = _RATE - len(data) % _RATE
    padded = data + ((b"\x01" + b"\x00" * (pad_len - 2) + b"\x80")
                     if pad_len >= 2 else b"\x81")
    for start in range(0, len(padded), _RATE):
        block = padded[start:start + _RATE]
        for i in range(_RATE // 8):
            state[i % 5][i // 5] ^= int.from_bytes(block[8 * i:8 * i + 8],
                                                   "little")
        state = _keccak_f_int(state)
    return b"".join(state[i % 5][i // 5].to_bytes(8, "little")
                    for i in range(4))


def blake2s256(data: bytes) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()


def to_montgomery_bytes(v: int) -> bytes:
    """Canonical felt -> its Montgomery representation as 32 BE bytes."""
    return (v * _R % P).to_bytes(32, "big")


def from_montgomery_int(u: int) -> int:
    """256-bit draw -> felt: (u mod p) read as a Montgomery representation."""
    return (u % P) * _R_INV % P


def mont_elements(elements) -> bytes:
    return b"".join(to_montgomery_bytes(int(e)) for e in elements)


def keep_first(digest: bytes, n: int = 20) -> bytes:
    """The masked Keccak digest: the n most-significant bytes kept."""
    return digest[:n] + b"\x00" * (len(digest) - n)


def keep_last(digest: bytes, n: int = 20) -> bytes:
    """The masked Blake2s digest: the n least-significant bytes kept."""
    return b"\x00" * (len(digest) - n) + digest[-n:]


def canonical_keccak_elements(elements) -> bytes:
    """Keccak-256 of canonical felts, 32 BE bytes each (the eth scheme's
    public-memory page hash)."""
    return keccak256(b"".join(int(e).to_bytes(32, "big") for e in elements))


def pedersen_elements(elements) -> int:
    """The cairo scheme's page hash: the length-tagged Pedersen chain."""
    return hash_chain(elements)
