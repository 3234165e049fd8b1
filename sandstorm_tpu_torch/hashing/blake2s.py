"""Blake2s-256 of Merkle leaves and nodes: the CUDA kernel (csrc/blake2s.cu)
and its plain PyTorch twin.

Messages are little-endian u32 word arrays ([N, W] int32 holding the bits);
the byte length defaults to 4 W.  RFC 7693, digest 32, no key.
"""

import hashlib

import torch

from .. import _native

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

_M32 = 0xFFFFFFFF


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & _M32


def _g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & _M32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & _M32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress(h, m, t: int, last: bool):
    v = list(h) + [torch.full_like(h[0], iv) for iv in IV]
    v[12] = v[12] ^ (t & _M32)
    v[13] = v[13] ^ ((t >> 32) & _M32)
    if last:
        v[14] = v[14] ^ _M32
    for s in SIGMA:
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake2s_words_plain(msg, nbytes: int):
    """Plain twin of the kernel, in int64 carriers: [N, W] -> [N, 8]."""
    w = msg.to(torch.int64) & _M32
    zeros = torch.zeros(msg.shape[:-1], dtype=torch.int64, device=msg.device)
    h = [torch.full_like(zeros, iv) for iv in IV]
    h[0] = h[0] ^ 0x01010020
    nblocks = max((nbytes + 63) // 64, 1)
    for blk in range(nblocks):
        m = []
        for k in range(16):
            byte0 = (blk * 16 + k) * 4
            if byte0 >= nbytes:
                m.append(zeros)
            elif nbytes - byte0 < 4:
                m.append(w[..., blk * 16 + k]
                         & ((1 << (8 * (nbytes - byte0))) - 1))
            else:
                m.append(w[..., blk * 16 + k])
        last = blk == nblocks - 1
        h = _compress(h, m, nbytes if last else (blk + 1) * 64, last)
    out = torch.stack(h, dim=-1)
    return (out - ((out >> 31) << 32)).to(torch.int32)


def blake2s_words(msg, nbytes: int = None):
    """Blake2s-256 of each row of a [N, W] int32 word array -> [N, 8]."""
    W = msg.shape[-1]
    nbytes = 4 * W if nbytes is None else nbytes
    if not 0 <= nbytes <= 4 * W:
        raise ValueError(f"blake2s: {nbytes} bytes in {W} words")
    if msg.device.type == "cpu":
        return blake2s_words_plain(msg, nbytes)
    msg = msg.contiguous()
    _native.check_cuda_tensor(msg, "blake2s msg")
    out = torch.empty(msg.shape[:-1] + (8,), dtype=torch.int32,
                      device=msg.device)
    _native.launch("blake2s_rows", msg.device, msg.data_ptr(),
                   msg.numel() // max(W, 1), W, nbytes, out.data_ptr())
    return out


def hash_rows(word_arrays):
    """Hash each row of a matrix given per-column [N, W_i] word arrays."""
    return blake2s_words(torch.cat(word_arrays, dim=-1))


def hash_node_pairs(level):
    """[2k, 8] digests -> [k, 8] parent digests (hash of left || right)."""
    return blake2s_words(level.reshape(level.shape[0] // 2, 16))


def blake2s_host(data: bytes) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()
