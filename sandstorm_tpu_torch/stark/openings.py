"""Out-of-domain openings of the committed columns.

Fp252: every (point, column) pair the AIR's trace arguments need, plus the
composition columns at z^m, goes through one pair-indexed opener call
(fields/fp252_cuda.py:open_pairs, the CUDA kernel on a CUDA tensor), which
groups the pairs by point so that a point's powers are formed once for all
of its columns.
Other fields (Goldilocks, GF(p^3)) take the dense opener, as the JAX
package does (sandstorm_tpu/stark/openings.py:118-143): every column at
every point (open_dense: one gl_open_dense call on a CUDA tensor,
csrc/gl_open.cu; its plain version a field multiply by the point's power
table and a pairwise add tree a point), one device-to-host copy for all
points.

The point powers pt^i are the outer product of two ~sqrt(n) tables,
pt^i = hi[i // b] * lo[i % b], both built on the device with running
products (a scan kernel launch each on a CUDA tensor).
"""

import torch

from .. import _native
from ..fields.fp252_cuda import open_pairs, sm_count
from ..fields.scan import prefix_mul

OPEN_DENSE_THREADS = 256      # THREADS in csrc/gl_open.cu
OPEN_DENSE_GROUP = 4          # GROUP in csrc/gl_open.cu: columns a block
OPEN_DENSE_BLOCKS_PER_SM = 8  # blocks the grid aims at per SM


def point_powers(F, pts, count: int, device):
    """[K, count, L] of pt^i for i < count (python-int points)."""
    base = F.encode_ints(pts, device)                         # [K, L]
    seq = torch.cat([F.ones((1, len(pts)), device),
                     base[None].expand(count - 1, -1, -1)], dim=0)
    return prefix_mul(F, seq).transpose(0, 1).contiguous()


def _power_tables(F, pts, n, device):
    """(lo [K, b, L], hi [K, n / b, L]) with pt^i = hi[i // b] lo[i % b].
    hi's base pt^b is a power of the host scalar F.s(pt): the packed int of
    a GF(p^3) element is not the field element, so the integer
    pow(pt, b, p^3) would be another number (Fq3S's pow ignores the
    modulus)."""
    b = 1 << ((n.bit_length() - 1) // 2)
    p = F.MODULUS
    lo = point_powers(F, pts, b, device)
    hi = point_powers(F, [int(pow(F.s(pt), b, p)) for pt in pts], n // b,
                      device)
    return lo, hi


def _open_pairs(F, col_arrays, pts, n, pairs):
    """(point_idx, col_idx) pairs -> list of python ints in pair order."""
    device = col_arrays[0].device
    cols = torch.stack(col_arrays)                            # [C, n, L]
    lo, hi = _power_tables(F, pts, n, device)
    if F.NAME == "fp252":
        return F.decode_ints(open_pairs(cols, lo, hi, [k for (k, _) in pairs],
                                        [c for (_, c) in pairs]))
    # dense: every column at every point, one host copy for all of them
    C = cols.shape[0]
    vals = F.decode_ints(open_dense(F, cols, lo, hi))         # [K * C]
    return [vals[k * C + c] for (k, c) in pairs]


def open_dense_plain(F, cols, lo, hi):
    """out[k, c] = sum_i cols[c, i] hi[k, i // b] lo[k, i % b] in plain
    field ops, a point at a time: its powers (the outer product of the two
    tables), one multiply of every column by them, a pairwise add tree.
    cols [C, n, L], lo [K, b, L], hi [K, n / b, L] -> [K, C, L]."""
    C, n, L = cols.shape
    outs = []
    for k in range(lo.shape[0]):
        x = F.mul(cols, F.mul(hi[k][:, None], lo[k][None, :]).reshape(n, L))
        while x.shape[1] > 1:
            x = F.add(x[:, 0::2], x[:, 1::2])
        outs.append(x[:, 0])
    return torch.stack(outs)


def open_dense(F, cols, lo, hi):
    """The dense opener of Goldilocks and GF(p^3) (see open_dense_plain,
    the plain version CPU tensors take): on a CUDA tensor one
    gl_open_dense call (two kernels: a partial sum a (point, column,
    range of i), then their reduce), whatever the number of points."""
    C, n, L = cols.shape
    K, b = lo.shape[0], lo.shape[1]
    if b & (b - 1) or n % b or hi.shape != (K, n // b, L) \
            or lo.shape != (K, b, L):
        raise ValueError(f"open_dense: bad power tables {tuple(lo.shape)}, "
                         f"{tuple(hi.shape)} for {tuple(cols.shape)}")
    if cols.device.type == "cpu":
        return open_dense_plain(F, cols, lo, hi)
    if F.NAME not in ("goldilocks", "gl3"):
        raise ValueError(f"open_dense: no kernel for {F.NAME}")
    cols, lo, hi = cols.contiguous(), lo.contiguous(), hi.contiguous()
    for name, t in (("cols", cols), ("lo", lo), ("hi", hi)):
        _native.check_cuda_tensor(t, f"gl_open_dense {name}", last_dim=L,
                                  align=8)
        if t.device != cols.device:
            raise ValueError(f"gl_open_dense {name} on {t.device}")
    ngroups = -(-C // OPEN_DENSE_GROUP)
    if K * ngroups > 65535:
        raise ValueError(f"gl_open_dense: {K} points x {ngroups} column "
                         f"groups exceed the grid's 65535")
    # the grid: (ranges of i, point x column group), a few blocks an SM in
    # all; a block strides over its range
    nranges = max(1, min(-(-n // OPEN_DENSE_THREADS),
                         OPEN_DENSE_BLOCKS_PER_SM * sm_count(cols.device)
                         // (K * ngroups)))
    chunk = -(-n // nranges)
    chunk = -(-chunk // OPEN_DENSE_THREADS) * OPEN_DENSE_THREADS
    nranges = -(-n // chunk)
    partial = torch.empty((K, C, nranges, L), dtype=torch.int32,
                          device=cols.device)
    out = torch.empty((K, C, L), dtype=torch.int32, device=cols.device)
    _native.launch("gl_open_dense", cols.device, cols.data_ptr(), C, n,
                   lo.data_ptr(), b.bit_length() - 1, hi.data_ptr(), K,
                   nranges, chunk, L, partial.data_ptr(), out.data_ptr())
    return out


def open_columns(F, coeffs_by_col, targs, z, g, n, extra_points=(),
                 extra_cols=None):
    """Open the committed columns at z*g^off for each (col, off) in targs,
    plus the given columns at each extra point.

    coeffs_by_col: dict col -> [n, L] coefficient tensors
    extra_cols: per-extra-point column-key lists (default: all columns)
    Returns (values {(col, off): int}, extra [{col: int}] per extra point).
    """
    pb = F.BASE_MODULUS
    cols = sorted(coeffs_by_col)
    col_pos = {c: i for i, c in enumerate(cols)}
    offsets = sorted({off for (_, off) in targs})
    zs = F.s(z)
    pts = [int(zs * pow(g, off % n, pb)) for off in offsets] \
        + [int(F.s(e)) for e in extra_points]
    pair_list = sorted({(offsets.index(off), col_pos[c])
                        for (c, off) in targs})
    for j in range(len(extra_points)):
        ecs = cols if extra_cols is None else extra_cols[j]
        pair_list += [(len(offsets) + j, col_pos[c]) for c in ecs]
    pv = _open_pairs(F, [coeffs_by_col[c] for c in cols], pts, n, pair_list)
    by_pair = dict(zip(pair_list, pv))
    values = {(c, off): by_pair[(offsets.index(off), col_pos[c])]
              for (c, off) in targs}
    extra = []
    for j in range(len(extra_points)):
        ecs = cols if extra_cols is None else extra_cols[j]
        extra.append({c: by_pair[(len(offsets) + j, col_pos[c])]
                      for c in ecs})
    return values, extra
