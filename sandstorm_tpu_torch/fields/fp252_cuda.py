"""Fp252 kernels (csrc/fp252.cu, csrc/open_pairs.cu, csrc/ec_madd.cu,
csrc/scan.cu) and their plain PyTorch twins.

An element is a ``[..., 8]`` int32 tensor holding the u32 limbs of its
Montgomery form (R = 2^256).  Each public function takes the plain version
for CPU tensors and launches its CUDA kernel for CUDA tensors; a CUDA launch
that fails raises.  launch_elementwise, the broadcast launch of the
elementwise kernels, serves fields/gl_cuda.py's Goldilocks kernels too;
the scan pair's launches (scan_launch, inv_prepare, inv_launch) serve
Fp252's, by the entries of _native.FIELD_KERNELS (the Goldilocks fields'
running product and batch inversion have their own in fields/gl_cuda.py).

The plain versions compute in int64 carriers and mask after every shift:
PyTorch's CPU backend has no add, shift or compare on uint32.  A 32x32-bit
product overflows signed int64, so the plain multiply works on sixteen
16-bit digits, as the JAX package's fields/fp252.py (_dmul_loose, _redc)
does.
"""

import math

import numpy as np
import torch

from .. import _native, _tables, telemetry
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


# -- the unreduced accumulate of csrc/fp252.cuh, checked alone ---------------

WIDE_TERMS = 16   # fp::WIDE_TERMS: products one redc may take


def dot_plain(a, b):
    """sum_j a[:, j] b[:, j] of [n, k, 8] tensors, one montmul and one
    modular add a term: [n, 8]."""
    acc = mul_plain(a[:, 0], b[:, 0])
    for j in range(1, a.shape[1]):
        acc = add_plain(acc, mul_plain(a[:, j], b[:, j]))
    return acc


def dot(a, b, plain_c: bool = False):
    """dot_plain's sum for CPU tensors; for CUDA tensors one launch of
    csrc/fp252.cu fp252_dot, which adds the k unreduced products (k up to
    WIDE_TERMS) with add_wide's carry chain (or, with plain_c, its plain-C
    twin) and reduces once.  No prove calls it: it checks the accumulate
    that the constraint-group kernels and deep_compose fold with."""
    if a.shape != b.shape or a.dim() != 3 or a.shape[-1] != 8:
        raise ValueError(f"dot: operands {tuple(a.shape)}, {tuple(b.shape)} "
                         f"are not one [n, k, 8] shape")
    n, k = a.shape[:2]
    if not 1 <= k <= WIDE_TERMS:
        raise ValueError(f"dot: {k} terms (one redc takes 1 to "
                         f"{WIDE_TERMS})")
    if a.device.type == "cpu":
        return dot_plain(a, b)
    a, b = a.contiguous(), b.contiguous()
    for name, t in (("a", a), ("b", b)):
        _native.check_cuda_tensor(t, f"fp252_dot {name}", last_dim=8)
    out = torch.empty((n, 8), dtype=torch.int32, device=a.device)
    _native.launch("fp252_dot", a.device, a.data_ptr(), b.data_ptr(), k,
                   int(plain_c), out.data_ptr(), n)
    return out


# -- the running product and the batch inversion along axis 0 ---------------

SCAN_THREADS = 256       # THREADS in csrc/scan.cu: the runs of a tile
SCAN_BLOCKS_PER_SM = 2   # MIN_BLOCKS in csrc/scan.cu
SCAN_RUN_MAX = 32        # rows a thread takes, at most
_R = 1 << 256
_R2 = _R * _R % P


def run_length(rows: int, sms: int) -> int:
    """Rows a thread takes in a call over `rows` rows in all: the largest
    power of two, 1 to SCAN_RUN_MAX, that leaves SCAN_BLOCKS_PER_SM tiles
    an SM in the grid (a short chain of dependent montmuls for a small
    call, fewer block scans and look-backs an element for a large one)."""
    fit = rows // (SCAN_THREADS * SCAN_BLOCKS_PER_SM * sms)
    return min(SCAN_RUN_MAX, 1 << max(fit, 1).bit_length() - 1)


def status_words(tiles: int, L: int = 8) -> int:
    """Words of one launch's look-back state (status_words in csrc/scan.cu
    and csrc/gl_scan.cu): the tile counter, a flag a tile, an aggregate
    and an inclusive prefix of L words (an element) a tile.  The C entry
    zeroes it with a memset before each launch."""
    return 8 + -(-tiles // 8) * 8 + 2 * L * tiles


def sm_count(device):
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ints_of(t):
    """[m, 8] int32 Montgomery words (any device) -> m python ints."""
    b = telemetry.to_host(t.reshape(-1, 8), "inv_totals").contiguous() \
        .numpy().tobytes()
    return [int.from_bytes(b[i:i + 32], "little")
            for i in range(0, len(b), 32)]


def _words_of(ints):
    """python ints < 2^256 -> a [len, 8] int32 numpy array of their words."""
    b = b"".join(int(v).to_bytes(32, "little") for v in ints)
    return np.frombuffer(b, dtype=np.int32).reshape(-1, 8).copy()


def _inverses(vals):
    """1 / v mod p of each python int (0 for 0): Montgomery's trick over
    the nonzero ones only (a zero folded in would zero them all), one
    modular inverse (pow(t, -1, p), the value of pow(t, p - 2, p))."""
    live = [v for v in vals if v]
    pre, acc = [], 1
    for v in live:
        pre.append(acc)
        acc = acc * v % P
    inv = pow(acc, -1, P)
    out = [0] * len(live)
    for i in range(len(live) - 1, -1, -1):
        out[i] = inv * pre[i] % P
        inv = inv * live[i] % P
    it = iter(out)
    return [next(it) if v else 0 for v in vals]


def invert_totals(totals):
    """The host trip of fp252_batch_inv: each column's total ([m, 8]
    Montgomery words t R) -> its inverse's, R^2 / (t R), on the same
    device; a zero stays zero.  One device-to-host copy (the call's one
    synchronize), one modular inverse for all of them (_inverses), one
    upload."""
    inv = [_R2 * v % P for v in _inverses(_ints_of(totals))]
    words = _words_of(inv)
    if totals.device.type == "cpu":
        return torch.from_numpy(words)
    return telemetry.to_device(words, totals.device, "inv_totals",
                               pinned=True)


def scan_launch(a, reverse: bool):
    """One launch of the running-product kernel of a CUDA [n, ..., L]
    tensor's field (_native.FIELD_KERNELS[L]: fp252_scan_mul, gl_scan_mul):
    a memset of its look-back state, then the chained scan."""
    L = a.shape[-1]
    k = _native.FIELD_KERNELS[L]
    entry, align = k["scan"], k["align"]
    a = a.contiguous()
    out = torch.empty_like(a)
    for name, t in (("a", a), ("out", out)):
        _native.check_cuda_tensor(t, f"{entry} {name}", last_dim=L,
                                  align=align)
    n = a.shape[0]
    C = a.numel() // (L * n) if n else 0
    if C == 0:
        return out
    if C >= 1 << 31:
        raise ValueError(f"{entry}: {C} columns do not fit an int")
    run = run_length(n * C, sm_count(a.device))
    tiles = C * -(-n // (SCAN_THREADS * run))
    status = torch.empty(status_words(tiles, L), dtype=torch.int32,
                         device=a.device)
    _native.launch(entry, a.device, a.data_ptr(), n, C, int(reverse), run,
                   *k["args"], out.data_ptr(), status.data_ptr())
    return out


def batch_inv_plain(a):
    """Montgomery batch inversion along axis 0 of an [n, ..., 8] tensor in
    plain ops (the kernel pair's plain version): the forward and reverse
    running products (prefix_scan of mul_plain), each column's total
    inverted by invert_totals, two products.  A zero in a column makes
    every inverse of that column zero, as in the JAX package."""
    n = a.shape[0]
    if n == 0:
        return a.clone()
    cols = a.reshape(n, -1, 8)
    pre = prefix_scan(mul_plain, cols)
    suf = prefix_scan(mul_plain, cols, True)
    one = torch.from_numpy(_words_of([_R % P])).to(a.device).expand(
        1, cols.shape[1], 8)
    t = mul_plain(torch.cat([one, pre[:n - 1]]), torch.cat([suf[1:], one]))
    return mul_plain(t, invert_totals(pre[n - 1])).reshape(a.shape)


def inv_tables(shapes, run: int):
    """The tiles of one fp252_batch_inv call over arrays (segments) of
    shapes (n, C): one row a tile, [segment, column, first row, rows, k,
    K], a column's K tiles consecutive with k = 0 .. K - 1, each of
    SCAN_THREADS runs of `run` rows (a column's last tile ragged); no tile
    crosses a column or a segment.  An int64 numpy array [tiles, 6]."""
    tile = SCAN_THREADS * run
    n = np.array([n for n, _ in shapes], dtype=np.int64).reshape(-1)
    C = np.array([C for _, C in shapes], dtype=np.int64).reshape(-1)
    # one entry a column of a segment, then one a tile of that column
    seg = np.repeat(np.arange(len(shapes), dtype=np.int64), C)
    col = np.arange(len(seg), dtype=np.int64) - np.repeat(np.cumsum(C) - C, C)
    K = np.repeat(-(-n // tile), C)
    k = np.arange(K.sum(), dtype=np.int64) - np.repeat(np.cumsum(K) - K, K)
    first = k * tile
    return np.stack([np.repeat(seg, K), np.repeat(col, K), first,
                     np.minimum(tile, np.repeat(n[seg], K) - first), k,
                     np.repeat(K, K)], axis=1)


def inv_prepare(arrays):
    """What fp252_batch_inv's two launches read, for non-empty contiguous
    [n, ..., 8] arrays on one CUDA device: the outputs, the segment rows
    ([in, out, n, C, first column]) and inv_tables' rows in one int64
    upload, the two look-back states, the runs' F and G, and the columns'
    totals, as a dict.  (Goldilocks and GF(p^3) take gl_cuda's one
    launch.)"""
    device = arrays[0].device
    L = arrays[0].shape[-1]
    if L != 8:
        raise ValueError(f"fp252_batch_inv: elements of {L} words")
    entry, align = (_native.FIELD_KERNELS[L][key] for key in ("inv", "align"))
    outs = [torch.empty_like(a) for a in arrays]
    for a, o in zip(arrays, outs):
        if a.device != device:
            raise ValueError(f"{entry}: arrays on {device} and {a.device}")
        for name, t in (("a", a), ("out", o)):
            _native.check_cuda_tensor(t, f"{entry} {name}", last_dim=L,
                                      align=align)
    shapes = [(a.shape[0], a.numel() // (L * a.shape[0])) for a in arrays]
    run = run_length(sum(n * C for n, C in shapes), sm_count(device))
    tiles = inv_tables(shapes, run)
    firsts = np.cumsum([0] + [C for _, C in shapes])
    segs = np.array([[a.data_ptr(), o.data_ptr(), n, C, f]
                     for a, o, (n, C), f in zip(arrays, outs, shapes, firsts)],
                    dtype=np.int64)
    ntiles = tiles.shape[0]
    return {"outs": outs, "run": run, "ntiles": ntiles, "nsegs": len(arrays),
            "L": L,
            "meta": telemetry.to_device(
                np.concatenate([segs.ravel(), tiles.ravel()]), device,
                "inv_tables", pinned=True),
            "status": torch.empty(2 * status_words(ntiles, L),
                                  dtype=torch.int32, device=device),
            "runs": torch.empty((ntiles * SCAN_THREADS, 2, L),
                                dtype=torch.int32, device=device),
            "totals": torch.empty((int(firsts[-1]), L), dtype=torch.int32,
                                  device=device)}


def inv_launch(job, phase: int, values):
    """One launch of the batch inversion on inv_prepare's tables: phase 0
    (the forward launch) writes each column's total into `values`, phase
    1 (the backward launch) reads each column's inverse total from it."""
    k = _native.FIELD_KERNELS[job["L"]]
    _native.launch(k["inv"], values.device, job["meta"].data_ptr(),
                   job["nsegs"], job["ntiles"], job["run"], phase, *k["args"],
                   job["status"].data_ptr(), job["runs"].data_ptr(),
                   values.data_ptr())


def batch_inv_cuda(arrays):
    """fp252_batch_inv of non-empty contiguous [n, ..., 8] CUDA arrays ->
    a list: the forward launch, the host trip of the columns' totals
    (invert_totals), the backward launch."""
    job = inv_prepare(arrays)
    inv_launch(job, 0, job["totals"])
    inv_launch(job, 1, invert_totals(job["totals"]))
    return job["outs"]


# -- the affine pair scan ----------------------------------------------------

AFFINE_RUNS = (1, 2, 4, 8)   # a thread's rows; AFFINE_MAX_RUN in csrc/scan.cu


def affine_plan(n: int, sms: int):
    """(run, tiles) of fp252_affine_scan over n maps on a card of `sms`
    SMs: the shortest run of AFFINE_RUNS whose tiles of SCAN_THREADS runs
    are at most one an SM (and so at most SCAN_THREADS: one block product
    takes every predecessor), all resident in one wave; past that the
    longest run, whose tiles look back over several steps beyond
    SCAN_THREADS of them.  One tile an SM: at 2^18 - 1 maps runs of 8 (128
    tiles of 2048 rows, 128 KB staged) took 0.045 ms on an H100 against
    0.059 for runs of 4 in 256 tiles, 2 an SM (PERF.md)."""
    cap = min(SCAN_THREADS, sms)
    for run in AFFINE_RUNS:
        tiles = max(1, -(-n // (SCAN_THREADS * run)))
        if tiles <= cap:
            return run, tiles
    run = AFFINE_RUNS[-1]
    return run, -(-n // (SCAN_THREADS * run))


def affine_status_words(tiles: int) -> int:
    """Words of fp252_affine_scan's look-back state (affine_status_words in
    csrc/scan.cu): the tile counter, a flag a tile and an aggregate of 16
    words (a map) a tile.  The C entry zeroes it before the launch."""
    return 8 + -(-tiles // 8) * 8 + 16 * tiles


def affine_launch(a, b):
    """One launch of fp252_affine_scan over CUDA [n, 8] arrays (a, b), the
    maps x -> x a_k + b_k: the [n + 1, 8] column whose row 0 is 1 and row
    k + 1 is a + b of the maps 0..k composed (first to last), the scan of
    the maps in tiles of one wave (a memset of its look-back state, then
    the scan; affine_plan's run and tiles)."""
    entry = _native.FIELD_KERNELS[8]["affine"]
    if a.shape != b.shape or a.dim() != 2 or a.shape[-1] != 8 \
            or a.device != b.device:
        raise ValueError(f"{entry}: maps {tuple(a.shape)} on {a.device}, "
                         f"{tuple(b.shape)} on {b.device} (one [n, 8] "
                         f"shape)")
    a, b = a.contiguous(), b.contiguous()
    n = a.shape[0]
    out = torch.empty((n + 1, 8), dtype=torch.int32, device=a.device)
    for name, t in (("a", a), ("b", b), ("out", out)):
        _native.check_cuda_tensor(t, f"{entry} {name}", last_dim=8)
    run, tiles = affine_plan(n, sm_count(a.device))
    status = torch.empty(affine_status_words(tiles), dtype=torch.int32,
                         device=a.device)
    _native.launch(entry, a.device, a.data_ptr(), b.data_ptr(), n, run,
                   out.data_ptr(), status.data_ptr())
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
    table, nranges, chunk, partial, counters = open_launch_setup(
        kidx, cidx, n, 8, cols.device)
    _native.launch("open_pairs", cols.device, cols.data_ptr(), n,
                   lo.data_ptr(), b.bit_length() - 1, hi.data_ptr(),
                   table.data_ptr(), table.shape[0], nranges, chunk,
                   partial.data_ptr(), counters.data_ptr(), out.data_ptr())
    return out


def open_launch_setup(kidx, cidx, n: int, L: int, device):
    """What a pair-indexed opener launch (open_pairs.cu, gl_open.cu) takes
    besides its columns and power tables, for pairs (kidx, cidx) over n
    coefficients of L words: (table, nranges, chunk, partial, counters).
    The table of pair_groups stays on the device (a prover opens the same
    pairs in every prove); the grid is (groups, ranges of i), a few blocks
    an SM in all, a block striding over its whole range of chunk indices
    (a multiple of OPEN_THREADS); partial [ngroups, nranges, OPEN_GROUP, L]
    and the zeroed counters [ngroups] are the launch's scratch."""
    table = _tables.device_table(f"open_groups:{kidx}:{cidx}", len(kidx),
                                 device, lambda: pair_groups(kidx, cidx))
    ngroups = table.shape[0]
    nranges = max(1, min(-(-n // OPEN_THREADS),
                         OPEN_BLOCKS_PER_SM * sm_count(device) // ngroups,
                         65535))
    chunk = -(-n // nranges)
    chunk = -(-chunk // OPEN_THREADS) * OPEN_THREADS
    nranges = -(-n // chunk)
    partial = torch.empty((ngroups, nranges, OPEN_GROUP, L),
                          dtype=torch.int32, device=device)
    counters = torch.zeros((ngroups,), dtype=torch.int32, device=device)
    return table, nranges, chunk, partial, counters


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
