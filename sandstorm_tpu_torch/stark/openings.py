"""Out-of-domain openings of the committed columns.

Fp252: every (point, column) pair the AIR's trace arguments need, plus the
composition columns at z^m, goes through one pair-indexed opener call
(fields/fp252_cuda.py:open_pairs, the CUDA kernel on a CUDA tensor), which
groups the pairs by point so that a point's powers are formed once for all
of its columns.
Other fields (Goldilocks, GF(p^3)) take the dense opener, as the JAX
package does (sandstorm_tpu/stark/openings.py:118-143): every column at
every point, a field multiply by the point's power table and a pairwise
add tree, one device-to-host copy for all points.

The point powers pt^i are the outer product of two ~sqrt(n) tables,
pt^i = hi[i // b] * lo[i % b], both built on the device with running
products.
"""

import torch

from ..fields.fp252_cuda import open_pairs
from ..fields.scan import prefix_mul


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
    C, _, L = cols.shape
    outs = []
    for k in range(len(pts)):
        x = F.mul(cols, F.mul(hi[k][:, None], lo[k][None, :]).reshape(n, L))
        while x.shape[1] > 1:
            x = F.add(x[:, 0::2], x[:, 1::2])
        outs.append(x[:, 0])
    vals = F.decode_ints(torch.stack(outs))                   # [K * C]
    return [vals[k * C + c] for (k, c) in pairs]


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
