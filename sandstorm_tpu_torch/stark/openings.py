"""Out-of-domain openings of the committed columns.

Every (point, column) pair the AIR's trace arguments need, plus the
composition columns at z^m, goes through one pair-indexed opener call,
which groups the pairs by point so that a point's powers are formed once
for all of its columns: over Fp252 fields/fp252_cuda.py:open_pairs (the
CUDA kernel csrc/open_pairs.cu on a CUDA tensor), over Goldilocks and
GF(p^3) open_pairs_gl (csrc/gl_open.cu), which takes the columns as a
list (no stack) and reads the base-field columns a GF(p^3) prove names as
one Goldilocks word.  The JAX package opens every column at every point
over those fields (sandstorm_tpu/stark/openings.py:118-143); the values
of the pairs are the same.  One device-to-host copy for all pairs.

The point powers pt^i are the outer product of two ~sqrt(n) tables,
pt^i = hi[i // b] * lo[i % b], both built on the device with running
products (a scan kernel launch each on a CUDA tensor).
"""

import ctypes

import torch

from .. import _native, telemetry
from ..fields.fp252_cuda import open_launch_setup, open_pairs, pair_groups
from ..fields.scan import prefix_mul

GL_OPEN_MAX_COLUMNS = 32      # MAXC in csrc/gl_open.cu: columns a call


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


def _open_pairs(F, col_arrays, pts, n, pairs, nbase=0):
    """(point_idx, col_idx) pairs -> list of python ints in pair order; the
    first nbase columns hold base-field values (read so over GF(p^3))."""
    device = col_arrays[0].device
    with telemetry.span("oods.prepare", points=len(pts)):
        lo, hi = _power_tables(F, pts, n, device)
        kidx, cidx = [k for (k, _) in pairs], [c for (_, c) in pairs]
    with telemetry.span("oods.launch", pairs=len(pairs)):
        if F.NAME == "fp252":
            out = open_pairs(torch.stack(col_arrays), lo, hi, kidx, cidx)
        else:
            out = open_pairs_gl(F, col_arrays, lo, hi, kidx, cidx, nbase)
    return F.decode_ints(out, "oods")


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


def open_pairs_gl_plain(F, cols, lo, hi, kidx, cidx):
    """The kernel's contract in plain ops: per row of pair_groups' table,
    open_dense_plain of its columns at its point, scattered to the pairs'
    positions.  cols: a list of [n, L] columns -> [P, L]."""
    table = pair_groups(kidx, cidx)
    group = (table.shape[1] - 2) // 2
    out = torch.zeros((len(kidx), lo.shape[-1]), dtype=torch.int32,
                      device=lo.device)
    for row in table.tolist():
        k, named = row[0], row[2:2 + row[1]]
        vals = open_dense_plain(F, torch.stack([cols[c] for c in named]),
                                lo[k:k + 1], hi[k:k + 1])[0]
        for j, p in enumerate(row[2 + group:2 + group + row[1]]):
            out[p] = vals[j]
    return out


def open_pairs_gl(F, cols, lo, hi, kidx, cidx, nbase: int = 0):
    """The pair-indexed opener of Goldilocks and GF(p^3):
    out[p] = sum_i cols[cidx[p]][i] hi[k, i // b] lo[k, i % b] for
    k = kidx[p].  cols: a list of C [n, L] columns (any row stride), the
    first nbase of them base-field values (their upper coordinates zero:
    the kernel reads their c0 word alone); the
    pairs in any order -> [P, L].  CPU tensors take open_pairs_gl_plain;
    CUDA tensors one gl_open_pairs launch."""
    kidx, cidx = list(kidx), list(cidx)
    K, b, L = lo.shape
    C = len(cols)
    n = cols[0].shape[0] if C else 0
    if not C or b & (b - 1) or n % b or hi.shape != (K, n // b, L) \
            or any(tuple(c.shape) != (n, L) for c in cols):
        raise ValueError(f"open_pairs_gl: bad power tables {tuple(lo.shape)}"
                         f", {tuple(hi.shape)} for {C} columns of "
                         f"{tuple(cols[0].shape) if C else ()}")
    P = len(kidx)
    if P != len(cidx) or any(not 0 <= k < K for k in kidx) \
            or any(not 0 <= c < C for c in cidx):
        raise ValueError(f"open_pairs_gl: bad pair lists ({P}, {len(cidx)})")
    if not 0 <= nbase <= C:
        raise ValueError(f"open_pairs_gl: {nbase} base columns of {C}")
    dev = cols[0].device
    if dev.type == "cpu":
        return open_pairs_gl_plain(F, cols, lo, hi, kidx, cidx)
    if F.NAME not in ("goldilocks", "gl3") or F.NLIMBS != L:
        raise ValueError(f"open_pairs_gl: no kernel for {F.NAME} on "
                         f"{L}-word elements")
    if C > GL_OPEN_MAX_COLUMNS:
        raise ValueError(f"open_pairs_gl: {C} columns exceed the kernel's "
                         f"{GL_OPEN_MAX_COLUMNS}")
    for name, t in (("lo", lo), ("hi", hi)):
        _native.check_cuda_tensor(t, f"gl_open_pairs {name}", last_dim=L,
                                  align=8)
        if t.device != dev:
            raise ValueError(f"gl_open_pairs {name} on {t.device}")
    for c in cols:
        if c.device != dev or c.dtype != torch.int32 or c.stride(1) != 1 \
                or c.stride(0) % 2 or c.data_ptr() % 8:
            raise ValueError("gl_open_pairs: a column is not rows of int32 "
                             "words, 8-byte aligned, on one device")
    out = torch.empty((P, L), dtype=torch.int32, device=dev)
    if P == 0:
        return out
    table, nranges, chunk, partial, counters = open_launch_setup(
        kidx, cidx, n, L, dev)
    arr = ctypes.c_longlong * C
    _native.launch("gl_open_pairs", dev, arr(*[c.data_ptr() for c in cols]),
                   arr(*[c.stride(0) for c in cols]), C, nbase, n,
                   lo.data_ptr(), b.bit_length() - 1, hi.data_ptr(),
                   table.data_ptr(), table.shape[0], nranges, chunk, L,
                   partial.data_ptr(), counters.data_ptr(), out.data_ptr())
    return out


def open_columns(F, coeffs_by_col, targs, z, g, n, extra_points=(),
                 extra_cols=None, base_cols=()):
    """Open the committed columns at z*g^off for each (col, off) in targs,
    plus the given columns at each extra point.

    coeffs_by_col: dict col -> [n, L] coefficient tensors
    extra_cols: per-extra-point column-key lists (default: all columns)
    base_cols: the keys whose columns hold base-field values (a GF(p^3)
      prove's base trace columns: the opener reads them as one Goldilocks
      word); they are placed first
    Returns (values {(col, off): int}, extra [{col: int}] per extra point).
    """
    pb = F.BASE_MODULUS
    base = sorted(set(base_cols) & set(coeffs_by_col))
    cols = base + sorted(set(coeffs_by_col) - set(base))
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
    pv = _open_pairs(F, [coeffs_by_col[c] for c in cols], pts, n, pair_list,
                     len(base))
    by_pair = dict(zip(pair_list, pv))
    values = {(c, off): by_pair[(offsets.index(off), col_pos[c])]
              for (c, off) in targs}
    extra = []
    for j in range(len(extra_points)):
        ecs = cols if extra_cols is None else extra_cols[j]
        extra.append({c: by_pair[(len(offsets) + j, col_pos[c])]
                      for c in ecs})
    return values, extra
