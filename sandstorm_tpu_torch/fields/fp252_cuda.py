"""Fp252 kernels (csrc/fp252.cu, csrc/open_pairs.cu, csrc/ec_madd.cu,
csrc/scan.cu) and their plain PyTorch twins.

An element is a ``[..., 8]`` int32 tensor holding the u32 limbs of its
Montgomery form (R = 2^256).  Each public function takes the plain version
for CPU tensors and launches its CUDA kernel for CUDA tensors; a CUDA launch
that fails raises.  launch_elementwise, the broadcast launch of the
elementwise kernels, serves fields/gl_cuda.py's Goldilocks kernels too.

The plain versions compute in int64 carriers and mask after every shift:
PyTorch's CPU backend has no add, shift or compare on uint32.  A 32x32-bit
product overflows signed int64, so the plain multiply works on sixteen
16-bit digits, as the JAX package's fields/fp252.py (_dmul_loose, _redc)
does.
"""

import math

import numpy as np
import torch

from .. import _native, _tables
from .scan import prefix_scan

P = (1 << 251) + 17 * (1 << 192) + 1
P_WORDS = [(P >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
assert P_WORDS == [1, 0, 0, 0, 0, 0, 17, 1 << 27]

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF


# -- plain versions ---------------------------------------------------------

def _words(x):
    """int32 [..., 8] -> list of 8 int64 tensors holding the u32 values."""
    w = x.to(torch.int64) & _M32
    return [w[..., k] for k in range(8)]


def _pack(words):
    """list of 8 int64 tensors (values < 2^32) -> int32 [..., 8]."""
    w = torch.stack(words, dim=-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _cond_sub_p(s):
    """8 int64 words of a value < 2p -> the value mod p."""
    d, borrow = [], 0
    for k in range(8):
        t = s[k] - P_WORDS[k] - borrow
        d.append(t & _M32)
        borrow = (t >> 63) & 1
    keep = borrow.bool()
    return [torch.where(keep, x, y) for x, y in zip(s, d)]


def add_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    aw, bw = _words(a), _words(b)
    s, c = [], 0
    for k in range(8):
        t = aw[k] + bw[k] + c
        s.append(t & _M32)
        c = t >> 32
    return _pack(_cond_sub_p(s))


def sub_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    aw, bw = _words(a), _words(b)
    d, borrow = [], 0
    for k in range(8):
        t = aw[k] - bw[k] - borrow
        d.append(t & _M32)
        borrow = (t >> 63) & 1
    e, c = [], 0
    for k in range(8):
        t = d[k] + P_WORDS[k] + c
        e.append(t & _M32)
        c = t >> 32
    wrapped = borrow.bool()
    return _pack([torch.where(wrapped, x, y) for x, y in zip(e, d)])


def mul_plain(a, b):
    """a * b * 2^-256 mod p over 16-bit digits in int64 carriers."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape[:-1]

    def digits(x):
        w = x.to(torch.int64) & _M32
        return torch.stack([w & _M16, w >> 16], dim=-1).reshape(
            shape + (16,))

    ad, bd = digits(a), digits(b)
    # 16x16 digit convolution: products < 2^32, 16 terms per digit < 2^36
    t = torch.zeros(shape + (33,), dtype=torch.int64, device=a.device)
    for j in range(16):
        t[..., j:j + 16] += ad * bd[..., j:j + 1]
    # REDC with p's nonzero digits 1 @0, 17 @12, 0x800 @15: t stays loose
    # (< 2^40) and is normalized once at the end
    c = torch.zeros(shape, dtype=torch.int64, device=a.device)
    for i in range(16):
        ti = t[..., i] + c
        m = (-ti) & _M16
        c = (ti + m) >> 16
        t[..., i + 12] += m * 17
        t[..., i + 15] += m << 11
    out, carry = [], c
    for k in range(17):
        v = t[..., 16 + k] + carry
        out.append(v & _M16)
        carry = v >> 16
    # result < 2p < 2^253: the 17th digit is zero after propagation
    words = [out[2 * k] | (out[2 * k + 1] << 16) for k in range(8)]
    return _pack(_cond_sub_p(words))


PLAIN = {"add": add_plain, "sub": sub_plain, "mul": mul_plain}


# -- kernel 1: elementwise multiply / add / subtract -------------------------

def _operand(x, shape):
    """(tensor, div, mod) so that element i of an output of `shape` reads
    element (i // div) % mod of the returned contiguous tensor; copies x
    only when its broadcast is not of that form.  x is [..., W] words per
    element (any W)."""
    W = x.shape[-1]
    xs = (1,) * (len(shape) - (x.dim() - 1)) + tuple(x.shape[:-1])
    if xs == tuple(shape):
        return x.contiguous(), 1, max(math.prod(shape), 1)
    live = [d for d, s in enumerate(xs) if s != 1]
    if not live:
        return x.reshape(W).contiguous(), 1, 1
    lo, hi = live[0], live[-1]
    if all(xs[d] == shape[d] for d in range(lo, hi + 1)):
        return (x.contiguous(), math.prod(shape[hi + 1:]),
                math.prod(xs[lo:hi + 1]))
    return x.expand(tuple(shape) + (W,)).contiguous(), 1, math.prod(shape)


def launch_elementwise(entry: str, a, b, width: int, align: int):
    """One launch of the elementwise C entry `entry` (this file's, or
    gl_cuda.py's Goldilocks ones) over broadcastable [..., width] operands
    on one CUDA device, each read in place by the (i // div) % mod rule of
    _operand; returns the new [..., width] result."""
    if a.device != b.device:
        raise ValueError(f"{entry}: operands on {a.device} and {b.device}")
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.empty(tuple(shape) + (width,), dtype=torch.int32,
                      device=a.device)
    at, a_div, a_mod = _operand(a, shape)
    bt, b_div, b_mod = _operand(b, shape)
    for name, t in (("a", at), ("b", bt), ("out", out)):
        _native.check_cuda_tensor(t, f"{entry} {name}", last_dim=width,
                                  align=align)
    _native.launch(entry, a.device, at.data_ptr(), a_div, a_mod,
                   bt.data_ptr(), b_div, b_mod, out.data_ptr(),
                   out.numel() // width)
    return out


def binop(op: str, a, b):
    """Fp252 `op` ('add' | 'sub' | 'mul') of broadcastable [..., 8] int32
    tensors; both on the CPU (plain version) or both on one CUDA device."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return PLAIN[op](a, b)
    return launch_elementwise(f"fp252_{op}", a, b, 8, 16)


# -- the running product along axis 0 ----------------------------------------

SCAN_TILE = 256 * 16     # rows a block of csrc/scan.cu takes (THREADS * RUN)


def scan_mul(a, reverse: bool = False, out=None):
    """Inclusive running product along axis 0 of an [n, ..., 8] tensor (from
    the end when reverse), into `out` (a new tensor if None; any contiguous
    tensor of a's shape, a view of a larger buffer included).  CPU tensors
    take the plain version, the Hillis-Steele prefix_scan of mul_plain; a
    CUDA tensor takes one fp252_scan_mul call (three launches)."""
    if a.device.type == "cpu":
        got = prefix_scan(mul_plain, a, reverse)
        if out is None:
            return got
        out.copy_(got)
        return out
    a = a.contiguous()
    if out is None:
        out = torch.empty_like(a)
    if out.shape != a.shape or out.device != a.device:
        raise ValueError(f"scan_mul: out {tuple(out.shape)} on {out.device} "
                         f"for {tuple(a.shape)} on {a.device}")
    for name, t in (("a", a), ("out", out)):
        _native.check_cuda_tensor(t, f"fp252_scan_mul {name}", last_dim=8)
    n = a.shape[0]
    C = a.numel() // (8 * n) if n else 0
    if C > 65535:
        raise ValueError(f"scan_mul: {C} columns (a grid dimension's most "
                         f"is 65535)")
    scratch = torch.empty((max(-(-n // SCAN_TILE), 1), max(C, 1), 8),
                          dtype=torch.int32, device=a.device)
    _native.launch("fp252_scan_mul", a.device, a.data_ptr(), n, C,
                   int(reverse), out.data_ptr(), scratch.data_ptr())
    return out


# -- kernel 3: pair-indexed opener ------------------------------------------

def tree_sum_plain(x):
    """Field sum over axis 0 (power-of-two length) with plain adds."""
    while x.shape[0] > 1:
        x = add_plain(x[0::2], x[1::2])
    return x[0]


def open_pairs_plain(cols, lo, hi, kidx, cidx):
    """out[p] = sum_i cols[cidx[p], i] * hi[kidx[p], i // b] * lo[kidx[p],
    i % b] with b = lo.shape[1]; cols [C, n, 8], lo [K, b, 8],
    hi [K, n / b, 8], kidx/cidx int sequences of length P -> [P, 8]."""
    n = cols.shape[1]
    powers = {}
    out = []
    for k, c in zip(kidx, cidx):
        k, c = int(k), int(c)
        if k not in powers:
            powers[k] = mul_plain(hi[k][:, None], lo[k][None, :]).reshape(n, 8)
        out.append(tree_sum_plain(mul_plain(cols[c], powers[k])))
    return torch.stack(out)


OPEN_GROUP = 4           # columns a block accumulates (GROUP in open_pairs.cu)
OPEN_THREADS = 256       # threads a block (THREADS in open_pairs.cu)
OPEN_BLOCKS_PER_SM = 32  # blocks the grid aims at per SM, over all groups


def pair_groups(kidx, cidx, group: int = OPEN_GROUP):
    """The pairs (kidx[p], cidx[p]), in any order, sorted into the kernel's
    groups: one point and up to `group` of its columns, in the order the
    pairs name them.  Returns a [ngroups, 2 + 2 group] int32 numpy table:
    the point, the number of columns, the column indices and, for the
    scatter back, each pair's position p (unused slots 0).  A point naming
    more columns than one group holds takes several rows."""
    by_point = {}
    for p, (k, c) in enumerate(zip(kidx, cidx)):
        by_point.setdefault(int(k), []).append((int(c), p))
    rows = []
    for k, named in by_point.items():
        for at in range(0, len(named), group):
            part = named[at:at + group]
            pad = [0] * (group - len(part))
            rows.append([k, len(part)] + [c for c, _ in part] + pad
                        + [p for _, p in part] + pad)
    return np.array(rows, dtype=np.int32).reshape(len(rows), 2 + 2 * group)


def open_groups_plain(cols, lo, hi, groups, num_pairs: int):
    """The kernel's contract with plain ops: per row of pair_groups' table
    the point's powers once, then one product and one sum per column,
    scattered to the pairs' positions -> [num_pairs, 8]."""
    n = cols.shape[1]
    group = (groups.shape[1] - 2) // 2
    out = torch.zeros((num_pairs, 8), dtype=torch.int32, device=cols.device)
    for row in groups.tolist():
        k, ncols = row[0], row[1]
        z = mul_plain(hi[k][:, None], lo[k][None, :]).reshape(n, 8)
        for c, p in zip(row[2:2 + ncols], row[2 + group:2 + group + ncols]):
            out[p] = tree_sum_plain(mul_plain(cols[c], z))
    return out


def open_pairs(cols, lo, hi, kidx, cidx):
    """The opener on [C, n, 8] coefficient columns; see open_pairs_plain.
    kidx/cidx are int sequences of one length, in any order.  CPU tensors
    take the plain version of the grouped form."""
    kidx, cidx = list(kidx), list(cidx)
    C, n, _ = cols.shape
    K, b, _ = lo.shape
    if b & (b - 1) or n % b or hi.shape != (K, n // b, 8):
        raise ValueError(f"open_pairs: bad power tables {tuple(lo.shape)}, "
                         f"{tuple(hi.shape)} for n = {n}")
    P = len(kidx)
    if P != len(cidx) or any(not 0 <= k < K for k in kidx) \
            or any(not 0 <= c < C for c in cidx):
        raise ValueError(f"open_pairs: bad pair lists ({P}, {len(cidx)})")
    if cols.device.type == "cpu":
        return open_groups_plain(cols, lo, hi, pair_groups(kidx, cidx), P)
    for name, t in (("cols", cols), ("lo", lo), ("hi", hi)):
        _native.check_cuda_tensor(t, f"open_pairs {name}", last_dim=8)
        if t.device != cols.device:
            raise ValueError(f"open_pairs {name} on {t.device}")
    out = torch.empty((P, 8), dtype=torch.int32, device=cols.device)
    if P == 0:
        return out
    # a prover opens the same pairs in every prove: their table stays on
    # the device
    table = _tables.device_table(f"open_groups:{kidx}:{cidx}", P, cols.device,
                                 lambda: pair_groups(kidx, cidx))
    # the grid: (groups, ranges of i), a few blocks per SM in all; a block
    # strides over its whole range
    sms = torch.cuda.get_device_properties(cols.device).multi_processor_count
    ngroups = table.shape[0]
    nranges = max(1, min(-(-n // OPEN_THREADS),
                         OPEN_BLOCKS_PER_SM * sms // ngroups, 65535))
    chunk = -(-n // nranges)
    chunk = -(-chunk // OPEN_THREADS) * OPEN_THREADS
    nranges = -(-n // chunk)
    partial = torch.empty((ngroups, nranges, OPEN_GROUP, 8), dtype=torch.int32,
                          device=cols.device)
    counters = torch.zeros((ngroups,), dtype=torch.int32, device=cols.device)
    _native.launch("open_pairs", cols.device, cols.data_ptr(), n,
                   lo.data_ptr(), b.bit_length() - 1, hi.data_ptr(),
                   table.data_ptr(), ngroups, nranges, chunk,
                   partial.data_ptr(), counters.data_ptr(), out.data_ptr())
    return out


# -- kernel 5: the Pedersen subset-sum walk of EC mixed adds -----------------

# 2^256 mod p, the Montgomery form of 1
ONE_MONT_WORDS = [((1 << 256) % P >> (32 * k)) & _M32 for k in range(8)]


def ec_madd_plain(X, Y, Z, x2, y2, skip):
    """One mixed Jacobian + affine add (madd-2007-bl, 7M + 4S) of [M, 8]
    Montgomery limb tensors, kept where `skip` ([M] bool) is set: the plain
    version of the JAX package's ec_madd_digitmajor (_ec_madd_tile).  The
    curve's a enters only doubling formulas, so the add is exact for the
    Starkware curve.  Returns (X3, Y3, Z3)."""
    mul, add, sub = mul_plain, add_plain, sub_plain
    Z1Z1 = mul(Z, Z)
    U2 = mul(x2, Z1Z1)
    S2 = mul(y2, mul(Z, Z1Z1))
    H = sub(U2, X)
    HH = mul(H, H)
    I2 = add(HH, HH)
    I = add(I2, I2)
    J = mul(H, I)
    r = sub(S2, Y)
    r = add(r, r)
    V = mul(X, I)
    X3 = sub(sub(mul(r, r), J), add(V, V))
    YJ = mul(Y, J)
    Y3 = sub(mul(r, sub(V, X3)), add(YJ, YJ))
    ZH = add(Z, H)
    Z3 = sub(sub(mul(ZH, ZH), Z1Z1), HH)
    keep = skip[:, None]
    return (torch.where(keep, X, X3), torch.where(keep, Y, Y3),
            torch.where(keep, Z, Z3))


def window_values(s, window_bits: int):
    """Canonical [M, 8] limbs -> [M, 256 / window_bits] int64 window values,
    least significant first (bytes or 16-bit digits)."""
    w = s.to(torch.int64) & _M32
    per = 32 // window_bits
    mask = (1 << window_bits) - 1
    return torch.stack([(w >> (window_bits * j)) & mask for j in range(per)],
                       dim=-1).reshape(s.shape[0], 8 * per)


def ec_madd_walk_plain(a, b, table, shift, window_bits: int):
    """The Pedersen subset-sum walk with plain ops: from the shift point
    (shift [16]: x then y, Montgomery; Z = 1), one ec_madd_plain per window,
    window k of a adding table[k, v] and window k of b table[W + k, v] for
    the window's value v (W = 256 / window_bits windows per input; v = 0
    adds nothing).  a, b: canonical [M, 8]; table [2 W, 2^bits, 16].
    Returns the Jacobian (X, Y, Z), Montgomery [M, 8] each."""
    M = a.shape[0]
    v = torch.cat([window_values(a, window_bits),
                   window_values(b, window_bits)], dim=1)
    X = shift[:8].expand(M, 8)
    Y = shift[8:].expand(M, 8)
    Z = _pack([torch.full((M,), w, dtype=torch.int64, device=a.device)
               for w in ONE_MONT_WORDS])
    for k in range(v.shape[1]):
        row = table[k][v[:, k]]
        X, Y, Z = ec_madd_plain(X, Y, Z, row[:, :8], row[:, 8:], v[:, k] == 0)
    return X, Y, Z


def ec_madd_walk(a, b, table, shift, window_bits: int):
    """The walk of ec_madd_walk_plain: the plain version for CPU tensors,
    one launch of csrc/ec_madd.cu (a thread per hash) for CUDA tensors."""
    if window_bits not in (8, 16):
        raise ValueError(f"ec_madd_walk: window_bits {window_bits}")
    W = 256 // window_bits
    if table.shape != (2 * W, 1 << window_bits, 16) or shift.shape != (16,):
        raise ValueError(f"ec_madd_walk: table {tuple(table.shape)}, shift "
                         f"{tuple(shift.shape)} for {window_bits}-bit windows")
    if a.shape != b.shape or a.dim() != 2 or a.shape[1] != 8:
        raise ValueError(f"ec_madd_walk: inputs {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return ec_madd_walk_plain(a, b, table, shift, window_bits)
    a, b = a.contiguous(), b.contiguous()
    M = a.shape[0]
    X, Y, Z = (torch.empty((M, 8), dtype=torch.int32, device=a.device)
               for _ in range(3))
    for name, t in (("a", a), ("b", b), ("table", table), ("shift", shift),
                    ("X", X), ("Y", Y), ("Z", Z)):
        _native.check_cuda_tensor(t, f"ec_madd_walk {name}")
        if t.device != a.device:
            raise ValueError(f"ec_madd_walk {name} on {t.device}")
    _native.launch("ec_madd_walk", a.device, a.data_ptr(), b.data_ptr(),
                   table.data_ptr(), shift.data_ptr(), window_bits, M,
                   X.data_ptr(), Y.data_ptr(), Z.data_ptr())
    return X, Y, Z
