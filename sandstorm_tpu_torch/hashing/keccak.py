"""Keccak-256 of Merkle leaves and nodes: the CUDA kernel (csrc/keccak.cu)
and its plain PyTorch twin (port of sandstorm_tpu/hashing/keccak.py).

Original Keccak (pad 0x01), as Ethereum's keccak256 and crypto/hashes.py's
host keccak256.  Messages are [N, W] int32 arrays holding the byte stream
as little-endian u32 words (byte k of the stream in word k // 4, byte
k % 4), which is how Keccak absorbs bytes into its little-endian 64-bit
lanes; digests are [N, 8] words of the same kind.  `keep_words` < 8 zeroes
digest words keep_words..7: MaskedKeccak256<4 keep_words> keeps the digest's
first 4 keep_words bytes.
"""

import torch

from .. import _native

_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# rotation offset of lane (x, y), flat index x + 5 y
_ROT = (
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
)

RATE_WORDS = 34  # the 136-byte rate of Keccak-256, in u32 words
_M32 = 0xFFFFFFFF


def _rotl64(lo, hi, r):
    """Rotate the 64-bit lane (lo, hi) of u32 halves in int64 carriers left
    by r, masking after every left shift."""
    r &= 63
    if r == 0:
        return lo, hi
    if r >= 32:
        lo, hi = hi, lo
        r -= 32
        if r == 0:
            return lo, hi
    return (((lo << r) & _M32) | (hi >> (32 - r)),
            ((hi << r) & _M32) | (lo >> (32 - r)))


def _round(lo, hi, rc):
    """One Keccak-f round on the 25 lanes' u32 halves (lists, flat index
    x + 5 y); returns the new lists."""
    c_lo = [lo[x] ^ lo[x + 5] ^ lo[x + 10] ^ lo[x + 15] ^ lo[x + 20]
            for x in range(5)]
    c_hi = [hi[x] ^ hi[x + 5] ^ hi[x + 10] ^ hi[x + 15] ^ hi[x + 20]
            for x in range(5)]
    lo, hi = list(lo), list(hi)
    for x in range(5):                                   # theta
        r_lo, r_hi = _rotl64(c_lo[(x + 1) % 5], c_hi[(x + 1) % 5], 1)
        d_lo = c_lo[(x + 4) % 5] ^ r_lo
        d_hi = c_hi[(x + 4) % 5] ^ r_hi
        for y in range(5):
            lo[x + 5 * y] = lo[x + 5 * y] ^ d_lo
            hi[x + 5 * y] = hi[x + 5 * y] ^ d_hi
    b_lo, b_hi = [None] * 25, [None] * 25
    for x in range(5):                                   # rho + pi
        for y in range(5):
            src, dst = x + 5 * y, y + 5 * ((2 * x + 3 * y) % 5)
            b_lo[dst], b_hi[dst] = _rotl64(lo[src], hi[src], _ROT[src])
    for y in range(5):                                   # chi
        for x in range(5):
            i, j, k = x + 5 * y, (x + 1) % 5 + 5 * y, (x + 2) % 5 + 5 * y
            lo[i] = b_lo[i] ^ ((b_lo[j] ^ _M32) & b_lo[k])
            hi[i] = b_hi[i] ^ ((b_hi[j] ^ _M32) & b_hi[k])
    lo[0] = lo[0] ^ (rc & _M32)                          # iota
    hi[0] = hi[0] ^ (rc >> 32)
    return lo, hi


def keccak256_words_plain(msg, keep_words: int = 8):
    """Plain twin of the kernel: [N, W] int32 words (4 W bytes) -> [N, 8],
    in u32 halves held in int64 carriers."""
    W = msg.shape[-1]
    w = msg.to(torch.int64) & _M32
    zeros = torch.zeros(msg.shape[:-1], dtype=torch.int64, device=msg.device)
    nblocks = W // RATE_WORDS + 1
    total = nblocks * RATE_WORDS

    def word(i):
        v = w[..., i] if i < W else zeros
        if i == W:                        # pad byte 0x01 after the message
            v = v ^ 0x01
        if i == total - 1:                # 0x80 in the block's last byte
            v = v ^ 0x80000000
        return v

    lo, hi = [zeros] * 25, [zeros] * 25
    for blk in range(nblocks):
        base = blk * RATE_WORDS
        lo = [lo[i] ^ word(base + 2 * i) if i < RATE_WORDS // 2 else lo[i]
              for i in range(25)]
        hi = [hi[i] ^ word(base + 2 * i + 1) if i < RATE_WORDS // 2
              else hi[i] for i in range(25)]
        for rc in _RC:
            lo, hi = _round(lo, hi, rc)
    out = [(lo, hi)[k % 2][k // 2] if k < keep_words else zeros
           for k in range(8)]
    out = torch.stack(out, dim=-1)
    return (out - ((out >> 31) << 32)).to(torch.int32)


def keccak256_words(msg, nbytes: int = None, keep_words: int = 8):
    """Keccak-256 of each row of a [N, W] int32 word array -> [N, 8].  The
    message is the whole 4 W bytes of a row (felt rows always are)."""
    W = msg.shape[-1]
    if nbytes is not None and nbytes != 4 * W:
        raise ValueError(f"keccak: {nbytes} bytes in {W} words; the device "
                         f"Keccak absorbs whole words")
    if not 0 <= keep_words <= 8:
        raise ValueError(f"keccak: keep_words {keep_words} not in 0..8")
    if msg.device.type == "cpu":
        return keccak256_words_plain(msg, keep_words)
    msg = msg.contiguous()
    _native.check_cuda_tensor(msg, "keccak msg", align=4)
    out = torch.empty(msg.shape[:-1] + (8,), dtype=torch.int32,
                      device=msg.device)
    _native.launch("keccak_rows", msg.device, msg.data_ptr(),
                   out.numel() // 8, W, keep_words, out.data_ptr())
    return out


def keccak_hash_rows(word_arrays, keep_words: int = 8):
    """Hash each row of a matrix given per-column [N, W_i] word arrays."""
    return keccak256_words(torch.cat(word_arrays, dim=-1),
                           keep_words=keep_words)


def keccak_hash_node_pairs(level, keep_words: int = 8):
    """[2k, 8] digests -> [k, 8] parent digests (keccak of left || right)."""
    return keccak256_words(level.reshape(level.shape[0] // 2, 16),
                           keep_words=keep_words)
