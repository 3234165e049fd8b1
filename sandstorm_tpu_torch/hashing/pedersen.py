"""Batched Pedersen hashing for the friendly Merkle tree's algebraic layers
(port of sandstorm_tpu/hashing/pedersen_tpu.py).

pedersen(a, b) is the x-coordinate of P0 plus a fixed-window subset sum of
table points picked by the bits of a and b (builtins/pedersen.py).  The
walk accumulates in Jacobian coordinates with mixed adds, so it needs no
inversion until the end: one batch inversion of Z, then x = X / Z^2.

Two window widths, chosen by the tensor's device:
- 8-bit windows (64 adds per hash) with the [64, 256, 16] table of the
  native batch (native._window_tables), uploaded once per device;
- 16-bit windows (32 adds per hash) with the [32, 65536, 16] table (128 MB),
  built once per device from the 8-bit table with the port's field ops
  (window k combines 8-bit windows 2k and 2k + 1).
CUDA tensors take the 16-bit walk, as the TPU did; CPU tensors the 8-bit
one, because building the 16-bit table through the plain ops would dominate
every test.  A table row is x limbs then y limbs of an affine point in
Montgomery form; entry 0 of each window (the identity) is never read.
"""

import numpy as np
import torch

from .. import _tables, native
from ..fields.fp252 import reverse_bytes32
from ..fields.fp252_cuda import ec_madd_walk

# windows combined per chunk of the 16-bit build: bounds its transient
# memory (each [8, 65536, 8] temporary is 16 MB)
COMBINE_CHUNK = 8


def _tables8_np():
    """([64, 256, 16] int32 table, [16] int32 shift) of the 8-bit walk."""
    table, shift = native._window_tables()  # [2, 32, 256, 8] u64, [8] u64
    t = np.ascontiguousarray(table).view("<u4").reshape(64, 256, 16)
    return t.view(np.int32), np.ascontiguousarray(shift).view(np.int32)


def shift_point(device):
    """P0 as [16] int32: x then y, Montgomery limbs."""
    return _tables.device_table("pedersen_shift", 16, device,
                                lambda: _tables8_np()[1])


def tables8(device):
    return _tables.device_table("pedersen_w8", 64 * 256, device,
                                lambda: _tables8_np()[0])


def combine_windows(F, lo, hi):
    """Affine sums lo[w, v & 255] + hi[w, v >> 8] for every 16-bit value v:
    lo, hi [W, 256, 16] -> [W, 65536, 16].  A zero byte adds nothing; v = 0
    stays the (never read) zero row.  One batch inversion covers the chunk.
    Two distinct nonzero entries never share an x (that would be a discrete
    log relation between the chain points), so the affine add is total."""
    device = lo.device
    v = torch.arange(65536, device=device)
    a_idx, b_idx = v & 0xFF, v >> 8
    x1, y1 = lo[:, a_idx, :8], lo[:, a_idx, 8:]
    x2, y2 = hi[:, b_idx, :8], hi[:, b_idx, 8:]
    a_zero = (a_idx == 0)[None, :, None]
    b_zero = (b_idx == 0)[None, :, None]
    one = F.ones((), device)
    den = torch.where(a_zero | b_zero, one, F.sub(x2, x1))
    inv = F.batch_inv(den.reshape(-1, 8)).reshape(den.shape)
    m = F.mul(F.sub(y2, y1), inv)
    x3 = F.sub(F.sub(F.sqr(m), x1), x2)
    y3 = F.sub(F.mul(m, F.sub(x1, x3)), y1)
    both = a_zero & b_zero
    out_x = torch.where(a_zero, x2, torch.where(b_zero, x1, x3))
    out_y = torch.where(a_zero, y2, torch.where(b_zero, y1, y3))
    out = torch.cat([out_x, out_y], dim=-1)
    return torch.where(both, torch.zeros_like(out), out)


def _build_tables16(F, device):
    t8 = tables8(device)
    chunks = []
    for s in range(0, 32, COMBINE_CHUNK):
        chunks.append(combine_windows(F, t8[2 * s:2 * (s + COMBINE_CHUNK):2],
                                      t8[2 * s + 1:2 * (s + COMBINE_CHUNK):2]))
    return torch.cat(chunks, dim=0)


def tables16(F, device):
    """The [32, 65536, 16] table on `device`, built there on first use."""
    return _tables.device_table("pedersen_w16", 32 * 65536, device,
                                lambda: _build_tables16(F, device))


def prewarm_tables(F, device):
    """Build the walk's table for `device` before a prove's arrays land."""
    if torch.device(device).type == "cuda":
        tables16(F, device)
    else:
        tables8(device)
    shift_point(device)


def hash_pairs(F, a, b):
    """pedersen(a[i], b[i]) for canonical [M, 8] limb tensors -> canonical
    [M, 8] x-coordinates, on the inputs' device: the walk (the ec_madd_walk
    kernel on a CUDA tensor, its plain version on a CPU tensor), one batch
    inversion of Z and x = X * Z^-2."""
    device = a.device
    if device.type == "cuda":
        X, _, Z = ec_madd_walk(a, b, tables16(F, device), shift_point(device),
                               16)
    else:
        X, _, Z = ec_madd_walk(a, b, tables8(device), shift_point(device), 8)
    native.HASHES.add(device.type, a.shape[0])
    z_inv = F.batch_inv(Z)
    return F.from_mont(F.mul(X, F.sqr(z_inv)))


def digest_words_to_canon(words):
    """[..., 8] LE u32 digest words -> canonical [..., 8] limbs of the felt
    read from the 32-byte digest BIG-endian (the friendly tree's Blake-to-
    felt boundary): canonical limb j = bswap(word[7 - j])."""
    return reverse_bytes32(words)
