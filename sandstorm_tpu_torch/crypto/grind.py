"""The proof-of-work grind of the two verifier coins, in batches on the
prove's device (port of sandstorm_tpu/crypto/grind.py): the CUDA kernel
(csrc/grind.cu, entry pow_grind) and its plain PyTorch twin.

Protocol (crypto/coins.py): a nonce is valid when
    leading_zero_bits(H(prefix32 || nonce_be8)) >= bits,
the digest read big-endian; for bits <= 32 that is one compare of the
digest's first four bytes, read big-endian, with 2^(32 - bits).  A batch
covers BATCH nonces from its start; the grind returns the smallest valid
nonce >= start.  H is Keccak-256 ("keccak", the Solidity coin) or
Blake2s-256 ("blake2s", the Cairo coin).  On a CUDA device one launch
covers a window of WINDOW batches and the host reads one result a window
(csrc/grind.cu's blocks stop once a smaller hit is known); the plain twin
takes the same window batch by batch.
"""

import numpy as np
import torch

from .. import _native
from ..hashing.blake2s import blake2s_words_plain
from ..hashing.keccak import keccak256_words_plain

BATCH = 1 << 16          # nonces a batch (the JAX package's dispatch)
WINDOW = 64              # batches a launch of csrc/grind.cu in grind()
MAX_BATCHES = 1 << 14    # 2^30 nonces, the JAX package's limit
HASH_IDS = {"keccak": 0, "blake2s": 1}
_M32 = 0xFFFFFFFF


def _bswap32(x):
    """Byte swap of u32 values held in int64 carriers."""
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x & 0xFF00) << 8) | ((x & 0xFF) << 24))


def _plain_batch(prefix_words, nonce0: int, bits: int, hash_name: str):
    """The offset (< BATCH) of the first valid nonce among nonce0 ..
    nonce0 + BATCH - 1, or BATCH if none."""
    dev = prefix_words.device
    nonces = nonce0 + torch.arange(BATCH, dtype=torch.int64, device=dev)
    msg = torch.cat([
        (prefix_words.to(torch.int64) & _M32).expand(BATCH, 8),
        _bswap32((nonces >> 32) & _M32)[:, None],
        _bswap32(nonces & _M32)[:, None]], dim=1)
    msg = (msg - ((msg >> 31) << 32)).to(torch.int32)
    if hash_name == "keccak":
        digests = keccak256_words_plain(msg)
    else:
        digests = blake2s_words_plain(msg, 40)
    lead = _bswap32(digests[:, 0].to(torch.int64) & _M32)
    ok = lead < (1 << (32 - bits)) if bits < 32 else lead == 0
    hits = torch.nonzero(ok)
    return int(hits[0, 0]) if hits.numel() else BATCH


def pow_grind_plain(prefix_words, nonce0: int, bits: int, hash_name: str,
                    batches: int = 1):
    """Plain twin of one kernel launch over `batches` batches: the offset
    (< batches * BATCH) of the first valid nonce among nonce0 .. nonce0 +
    batches * BATCH - 1, or batches * BATCH if none; batch by batch,
    stopping at the first batch with a hit.  prefix_words: [8] int32 LE
    words of the prefix, on any device."""
    for b in range(batches):
        idx = _plain_batch(prefix_words, nonce0 + b * BATCH, bits, hash_name)
        if idx < BATCH:
            return b * BATCH + idx
    return batches * BATCH


def pow_grind(prefix_words, nonce0: int, bits: int, hash_name: str,
              batches: int = 1) -> int:
    """One window of `batches` batches on prefix_words' device: the kernel
    on a CUDA tensor (one launch, then one read of its result), the plain
    twin on a CPU one.  Returns pow_grind_plain's offset."""
    if prefix_words.device.type == "cpu":
        return pow_grind_plain(prefix_words, nonce0, bits, hash_name,
                               batches)
    count = batches * BATCH
    if batches < 1 or count >= 1 << 31:
        raise ValueError(f"pow_grind: {batches} batches, not 1 .. 2^15 - 1")
    _native.check_cuda_tensor(prefix_words, "grind prefix", last_dim=8,
                              align=4)
    out = torch.empty((1,), dtype=torch.int32, device=prefix_words.device)
    _native.launch("pow_grind", prefix_words.device, prefix_words.data_ptr(),
                   nonce0, bits, HASH_IDS[hash_name], count, out.data_ptr())
    idx = int(out.item()) & _M32
    return min(idx, count)


def grind(hash_name: str, prefix: bytes, bits: int, start: int = 1, *,
          device) -> int:
    """The smallest nonce >= start whose hash under `hash_name` has `bits`
    leading zero bits, ground in windows of WINDOW batches on `device`."""
    if len(prefix) != 32:
        raise ValueError(f"grind: the prefix is {len(prefix)} bytes, not 32")
    if not 0 < bits <= 32:
        raise ValueError(f"grind: {bits} bits, not 1..32")
    if hash_name not in HASH_IDS:
        raise ValueError(f"grind: unknown hash {hash_name!r}")
    if not 0 <= start < 1 << 63:
        raise ValueError(f"grind: start {start} out of range")
    prefix_words = torch.from_numpy(
        np.frombuffer(prefix, dtype="<u4").view(np.int32).copy()).to(device)
    nonce0 = start
    for _ in range(-(-MAX_BATCHES // WINDOW)):
        idx = pow_grind(prefix_words, nonce0, bits, hash_name, WINDOW)
        if idx < WINDOW * BATCH:
            return nonce0 + idx
        nonce0 += WINDOW * BATCH
    raise RuntimeError(f"no valid nonce in {MAX_BATCHES} batches from "
                       f"{start}")
