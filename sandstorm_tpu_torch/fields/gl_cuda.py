"""Goldilocks kernels (csrc/goldilocks.cu) and their plain PyTorch twins,
with the plain versions of csrc/gl_scan.cu's running product and batch
inversion (launched through fields/scan.py) and their launches: the
running product's (scan_launch: one launch on scan_tiles' tiles, a memset
before it only where a column group chains) and the batch inversion's
(batch_inv_cuda: one launch, its segment rows in the launch's
parameters).

An element of GF(p), p = 2^64 - 2^32 + 1, is a ``[..., 2]`` int32 tensor
holding the (lo, hi) u32 words of its canonical value; an element of
GF(p^3) = GF(p)[x] / (x^3 - 2) is a ``[..., 6]`` tensor of three such
coordinates.  Each public function takes the plain version for CPU tensors
and launches its CUDA kernel for CUDA tensors; a CUDA launch that fails
raises.

The plain versions compute in int64 carriers on u32 words and mask after
every step: PyTorch's CPU backend has no unsigned 64-bit arithmetic.  They
mirror the JAX package's gl_mul_tile / gl_add_tile / gl_sub_tile
(fields/gl_pallas.py:29-51) and GL.reduce128 (fields/goldilocks.py:147)
step by step; the 64 x 64-bit product is taken on 16-bit digits, whose
partial products fit a signed int64.
"""

import numpy as np
import torch

from .. import _native, telemetry
from .fp252_cuda import launch_elementwise
from .scan import prefix_scan

P = (1 << 64) - (1 << 32) + 1
NR = 2                      # x^3 = NR in GF(p^3)

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF
EPS = _M32                  # 2^64 mod p


# -- plain versions ---------------------------------------------------------

def _words(x):
    """int32 [..., 2] -> (lo, hi) int64 tensors holding the u32 values."""
    w = x.to(torch.int64) & _M32
    return w[..., 0], w[..., 1]


def _pack(lo, hi):
    """(lo, hi) int64 tensors (values < 2^32) -> int32 [..., 2]."""
    w = torch.stack([lo, hi], dim=-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _add64(alo, ahi, blo, bhi):
    """(a + b) mod 2^64 as (lo, hi) and the carry out (0 or 1)."""
    t = alo + blo
    lo, c = t & _M32, t >> 32
    t = ahi + bhi + c
    return lo, t & _M32, t >> 32


def _sub64(alo, ahi, blo, bhi):
    """(a - b) mod 2^64 as (lo, hi) and the borrow out (0 or 1)."""
    t = alo - blo
    lo, br = t & _M32, (t >> 63) & 1
    t = ahi - bhi - br
    return lo, t & _M32, (t >> 63) & 1


def _cond_sub_p(lo, hi):
    """A value below 2p (as 64 bits) -> the value mod p."""
    dlo, dhi, br = _sub64(lo, hi, 1, _M32)
    keep = br.bool()
    return torch.where(keep, lo, dlo), torch.where(keep, hi, dhi)


def _mul_wide(alo, ahi, blo, bhi):
    """The 128-bit product as four u32 words, least significant first."""
    ad = [alo & _M16, alo >> 16, ahi & _M16, ahi >> 16]
    bd = [blo & _M16, blo >> 16, bhi & _M16, bhi >> 16]
    # digit convolution: products < 2^32, at most 4 terms per digit
    digits, carry = [], 0
    for k in range(8):
        t = carry
        for i in range(max(0, k - 3), min(k, 3) + 1):
            t = t + ad[i] * bd[k - i]
        digits.append(t & _M16)
        carry = t >> 16
    return [digits[2 * k] | (digits[2 * k + 1] << 16) for k in range(4)]


def _reduce128(w0, w1, w2, w3):
    """x = w0 + w1 2^32 + w2 2^64 + w3 2^96 mod p, with 2^64 = 2^32 - 1 and
    2^96 = -1: (lo - w3) + w2 (2^32 - 1), borrow and carry folded."""
    zero = torch.zeros_like(w0)
    t_lo, t_hi, br = _sub64(w0, w1, w3, zero)
    t_lo, t_hi, _ = _sub64(t_lo, t_hi, br * EPS, zero)
    # w2 * (2^32 - 1) = w2 * 2^32 - w2
    t1_lo, t1_hi, _ = _sub64(zero, w2, w2, zero)
    r_lo, r_hi, c = _add64(t_lo, t_hi, t1_lo, t1_hi)
    r_lo, r_hi, _ = _add64(r_lo, r_hi, c * EPS, zero)
    return _cond_sub_p(r_lo, r_hi)


def add_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    alo, ahi = _words(a)
    blo, bhi = _words(b)
    lo, hi, c = _add64(alo, ahi, blo, bhi)
    lo, hi, _ = _add64(lo, hi, c * EPS, torch.zeros_like(c))
    return _pack(*_cond_sub_p(lo, hi))


def sub_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    alo, ahi = _words(a)
    blo, bhi = _words(b)
    lo, hi, br = _sub64(alo, ahi, blo, bhi)
    lo, hi, _ = _sub64(lo, hi, br * EPS, torch.zeros_like(br))
    return _pack(lo, hi)


def mul_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return _pack(*_reduce128(*_mul_wide(*_words(a), *_words(b))))


PLAIN = {"add": add_plain, "sub": sub_plain, "mul": mul_plain}


def gl3_mul_plain(a, b):
    """GF(p^3) product of [..., 6] tensors: GL3.mul of the JAX package
    (fields/gl3.py:284), 9 base multiplies and the x^3 = 2 reduction,
    through the plain GL ops."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a[..., 0:2], a[..., 2:4], a[..., 4:6]
    b0, b1, b2 = b[..., 0:2], b[..., 2:4], b[..., 4:6]
    M, A = mul_plain, add_plain
    nr = torch.tensor([NR, 0], dtype=torch.int32, device=a.device)
    d0 = M(a0, b0)
    d1 = A(M(a0, b1), M(a1, b0))
    d2 = A(A(M(a0, b2), M(a1, b1)), M(a2, b0))
    d3 = A(M(a1, b2), M(a2, b1))
    d4 = M(a2, b2)
    return torch.cat([A(d0, M(d3, nr)), A(d1, M(d4, nr)), d2], dim=-1)


def check_base_embedded(cols, what: str):
    """Raise unless every [..., 6] GF(p^3) column in `cols` holds base-field
    values (its upper coordinates zero): what the typed kernels (the
    generated group kernels, gl_open_pairs, gl_deep_compose) read as one
    Goldilocks word.  Goldilocks columns pass as they are.  One reduction
    a column and, on a card, one read of the verdict (a synchronize)."""
    base_embedded_verdict(cols, what)()


def base_embedded_verdict(cols, what: str):
    """check_base_embedded in two steps: the reductions and the copy of
    their verdict to pinned host memory are queued now, and the function
    returned raises as check_base_embedded does, waiting only for that
    copy (an event recorded behind it), so the work queued in between
    runs on.  CPU columns are read at once."""
    cols = [c for c in cols if c.shape[-1] == 6]
    if not cols:
        return lambda: None
    flag = torch.stack([c[..., 2:].any() for c in cols]).any()
    if flag.device.type == "cpu":
        host, done = flag, None
    else:
        host = torch.empty((), dtype=torch.bool, pin_memory=True)
        host.copy_(flag, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(flag.device))

    def verdict():
        if done is not None:
            with telemetry.span("sync.verdict"):
                done.synchronize()
        if bool(host):
            raise ValueError(f"{what}: a column named base-field has nonzero "
                             f"upper coordinates")
    return verdict


# -- the kernels ------------------------------------------------------------

def binop(op: str, a, b):
    """Goldilocks `op` ('add' | 'sub' | 'mul') of broadcastable [..., 2]
    int32 tensors; both on the CPU (plain version) or both on one CUDA
    device."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return PLAIN[op](a, b)
    return launch_elementwise(f"gl_{op}", a, b, 2, 8)


def gl3_mul(a, b):
    """GF(p^3) product of broadcastable [..., 6] int32 tensors: one launch
    of csrc/goldilocks.cu's gl3_mul on a CUDA device."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gl3_mul_plain(a, b)
    return launch_elementwise("gl3_mul", a, b, 6, 8)


# -- the running product and the batch inversion (csrc/gl_scan.cu) -----------

def _field(L: int):
    """The field class of [..., L] elements (2: GL, 6: GF(p^3))."""
    from .gl3 import GL3
    from .goldilocks import GL
    if L not in (2, 6):
        raise ValueError(f"gl_scan: elements of {L} words are neither GL's "
                         f"(2) nor GF(p^3)'s (6)")
    return GL if L == 2 else GL3


def plain_ops(L: int):
    """The plain (add, sub, mul) of broadcastable [..., L] elements: GL's
    (L = 2) or GF(p^3)'s (L = 6: add and sub coordinatewise, on the
    [..., 3, 2] view)."""
    _field(L)
    if L == 2:
        return add_plain, sub_plain, mul_plain

    def coords(f):
        def op(a, b):
            out = f(a.reshape(a.shape[:-1] + (3, 2)),
                    b.reshape(b.shape[:-1] + (3, 2)))
            return out.reshape(out.shape[:-2] + (6,))
        return op
    return coords(add_plain), coords(sub_plain), gl3_mul_plain


def gl_inv_plain(a):
    """gl::inv (csrc/goldilocks.cuh) in plain ops: a^(p - 2) of [..., 2]
    elements (0 for 0) by its addition chain, t_k = a^(2^k - 1), then
    t_31^(2^33) t_32; the model its device route is held to."""
    M = mul_plain

    def sqn(x, k):
        for _ in range(k):
            x = M(x, x)
        return x

    t1 = a
    t2 = M(M(t1, t1), t1)
    t3 = M(M(t2, t2), t1)
    t6 = M(sqn(t3, 3), t3)
    t12 = M(sqn(t6, 6), t6)
    t24 = M(sqn(t12, 12), t12)
    t30 = M(sqn(t24, 6), t6)
    t31 = M(M(t30, t30), t1)
    t32 = M(M(t31, t31), t1)
    return M(sqn(t31, 33), t32)


def gl3_inv_plain(a):
    """The device's GF(p^3) inversion (csrc/goldilocks.cuh gl3::norm, then
    gl::inv and a product by t: gl_batch_inv's route) in plain ops on
    [..., 6] elements: t = a^p a^(p^2) (the Frobenius maps scale
    coordinate 1 by OMEGA and OMEGA^2, coordinate 2 by OMEGA^2 and OMEGA),
    the norm's c0 a0 t0 + 2 (a1 t2 + a2 t1), its gl_inv_plain, t times it
    (0 for 0)."""
    from .gl3 import OMEGA, OMEGA2

    def const(v):
        return _pack(torch.tensor(v & _M32), torch.tensor(v >> 32)).to(
            a.device)

    def scaled(w1, w2):
        return torch.cat([a[..., 0:2], mul_plain(a[..., 2:4], const(w1)),
                          mul_plain(a[..., 4:6], const(w2))], dim=-1)

    t = gl3_mul_plain(scaled(OMEGA, OMEGA2), scaled(OMEGA2, OMEGA))
    cross = add_plain(mul_plain(a[..., 2:4], t[..., 4:6]),
                      mul_plain(a[..., 4:6], t[..., 2:4]))
    norm = add_plain(mul_plain(a[..., 0:2], t[..., 0:2]),
                     add_plain(cross, cross))
    ninv = gl_inv_plain(norm)
    return torch.cat([mul_plain(t[..., 2 * k:2 * k + 2], ninv)
                      for k in range(3)], dim=-1)


def host_inverses(F, vals):
    """1 / v of each python int (packed for GF(p^3)) in the field F, 0 for
    0: Montgomery's trick over the nonzero ones only, one inversion in the
    field (GL: pow(t, p - 2, p); GF(p^3): Fq3S.inv, the value of its Fermat
    power t^(p^3 - 2))."""
    s = F.s
    live = [s(v) for v in vals if int(v)]
    if not live:
        return [0] * len(vals)
    pre, acc = [], s(1)
    for v in live:
        pre.append(acc)
        acc = acc * v % F.MODULUS
    inv = s(pow(acc, P - 2, P)) if F.NAME == "goldilocks" else acc.inv()
    out = [0] * len(live)
    for i in range(len(live) - 1, -1, -1):
        out[i] = int(inv * pre[i] % F.MODULUS)
        inv = inv * live[i] % F.MODULUS
    it = iter(out)
    return [next(it) if int(v) else 0 for v in vals]


def invert_totals(totals):
    """Each column's total ([m, L] words) -> its inverse's, on the same
    device; a zero stays zero: one inversion in the field for all of them
    (host_inverses).  The plain version's inversion (batch_inv_plain); the
    card's route inverts on the device (gl_batch_inv) and never comes
    here."""
    F = _field(totals.shape[-1])
    words = F.encode_ints_np(host_inverses(F, F.decode_ints(totals)))
    if totals.device.type == "cpu":
        return torch.from_numpy(words)
    return telemetry.to_device(words, totals.device, "inv_totals",
                               pinned=True)


def batch_inv_plain(a):
    """Montgomery batch inversion along axis 0 of an [n, ..., L] tensor in
    plain ops on any device (gl_batch_inv's plain version): the forward
    and reverse running products (prefix_scan of the plain multiply), each
    column's total inverted by invert_totals, two products.  A zero in a
    column makes every inverse of that column zero, as in the JAX
    package."""
    n, L = a.shape[0], a.shape[-1]
    if n == 0:
        return a.clone()
    mul = plain_ops(L)[2]
    cols = a.reshape(n, -1, L)
    pre = prefix_scan(mul, cols)
    suf = prefix_scan(mul, cols, True)
    one = _field(L).ones((1, cols.shape[1]), a.device)
    t = mul(torch.cat([one, pre[:n - 1]]), torch.cat([suf[1:], one]))
    return mul(t, invert_totals(pre[n - 1])).reshape(a.shape)


# -- gl_batch_inv's launch (csrc/gl_scan.cu) ----------------------------------

INV_THREADS = 256        # INV_THREADS in csrc/gl_scan.cu
# a tile's elements (rows of one column): InvRows<Fd>::M rows a thread,
# their products before each in registers
INV_ROWS = {2: 16 * INV_THREADS, 6: 8 * INV_THREADS}
INV_SEG = 8              # int64 words of a segment row (INV_SEG)
INV_MAX_SEGS = 32        # segments a launch (INV_MAX_SEGS)


def inv_segments(shapes, L: int):
    """The segment rows of one gl_batch_inv launch over arrays (segments)
    of shapes (n, C), n >= 1, at most INV_MAX_SEGS: an int64 numpy array
    [segments, INV_SEG] of [in, out, n, C, R, cw, first tile, first
    column], the pointers 0 (batch_inv_cuda sets them), with the launch's
    tiles and columns.  A tile is R rows of cw columns: all C columns
    where INV_THREADS rows of each fit a tile (R = INV_ROWS[L] // C rows,
    at most n), else column groups of INV_ROWS[L] // INV_THREADS columns
    of INV_THREADS rows; a segment's tiles are consecutive, row block
    after row block, each cut into its column groups.  A column's flag is
    word 1 + first column + its index of the launch's scratch
    (inv_tile)."""
    if not 0 < len(shapes) <= INV_MAX_SEGS:
        raise ValueError(f"gl_batch_inv: {len(shapes)} segments a launch")
    E = INV_ROWS[L]
    rows, tile, col = [], 0, 0
    for n, C in shapes:
        if n < 1 or C < 1:
            raise ValueError(f"gl_batch_inv: a segment of shape ({n}, {C})")
        cw = C if C * INV_THREADS <= E else E // INV_THREADS
        R = min(n, E // cw)
        rows.append([0, 0, n, C, R, cw, tile, col])
        tile += -(-n // R) * -(-C // cw)
        col += C
    return np.array(rows, dtype=np.int64), tile, col


def inv_tile(segs, tile: int):
    """The kernel's reading of tile `tile` of inv_segments' rows: (segment,
    first row, rows, first column, columns, the columns' flag words)."""
    s = int(np.searchsorted(segs[:, 6], tile, side="right")) - 1
    _, _, n, C, R, cw, first, col = (int(w) for w in segs[s])
    groups = -(-C // cw)
    k = tile - first
    r0, c0 = k // groups * R, k % groups * cw
    cols = min(cw, C - c0)
    return (s, r0, min(R, n - r0), c0, cols,
            [1 + col + c0 + c for c in range(cols)])


def batch_inv_cuda(arrays):
    """Montgomery batch inversion along axis 0 of each of `arrays`
    (non-empty contiguous [n, ..., L] CUDA tensors of one field, L = 2 or
    6, on one device) -> a list: one gl_batch_inv launch a group of
    INV_MAX_SEGS arrays (inv_segments' rows passed by value, a scratch of
    1 + columns words zeroed in the launch), tile-local inverses on the
    device; no device-to-host copy and no synchronize."""
    device = arrays[0].device
    L = arrays[0].shape[-1]
    _field(L)
    entry = _native.FIELD_KERNELS[L]["inv"]
    for a in arrays:
        if a.device != device:
            raise ValueError(f"{entry}: arrays on {device} and {a.device}")
        _native.check_cuda_tensor(a, entry, last_dim=L, align=8)
    outs = [torch.empty_like(a) for a in arrays]
    for at in range(0, len(arrays), INV_MAX_SEGS):
        part = range(at, min(at + INV_MAX_SEGS, len(arrays)))
        segs, tiles, cols = inv_segments(
            [(arrays[i].shape[0],
              arrays[i].numel() // (L * arrays[i].shape[0])) for i in part],
            L)
        segs[:, 0] = [arrays[i].data_ptr() for i in part]
        segs[:, 1] = [outs[i].data_ptr() for i in part]
        scratch = torch.empty(1 + cols, dtype=torch.int32, device=device)
        _native.launch(entry, device, segs.ctypes.data, len(part), tiles,
                       cols, L, scratch.data_ptr())
    return outs


# -- gl_scan_mul's launch (csrc/gl_scan.cu) -----------------------------------

SCAN_THREADS = 256       # SCAN_THREADS in csrc/gl_scan.cu
SCAN_MAX_COLS = 32       # columns a tile, at most (SCAN_MAX_COLS)
SCAN_MAX_RUN = 32        # rows a thread, at most (SCAN_MAX_RUN)
# rows a thread, at most, in a call whose column groups take more than one
# tile, and the tiles such a call keeps at least (down to a row a thread):
# a tile's fixed cost (the scan over its threads, the look-back) against
# blocks enough for the card's SMs, as measured on the H100
SCAN_RUN = {2: 32, 6: 32}
SCAN_MIN_TILES = 128


def _pow2_at_least(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def _pow2_at_most(v: int) -> int:
    return 1 << (v.bit_length() - 1)


def scan_tiles(n: int, C: int, L: int):
    """The tiles of one gl_scan_mul call over an [n, C, L] array (n, C >=
    1): (m, cw, R, per_group, groups), m rows a thread and cw columns a
    tile (powers of two; the kernel takes their logarithms), R = m
    SCAN_THREADS / cw rows a tile, per_group row blocks of a column group
    and groups column groups of cw columns (the last may hold fewer).
    Where a column's n rows fit SCAN_THREADS SCAN_RUN[L] elements, each
    column is one tile of all its rows, the fewest rows a thread that
    cover them: no look-back, no memset, the shortest chains of
    dependent products (such a call's time is their latency).  Otherwise
    a tile spans all C columns up to SCAN_MAX_COLS, its rows read as one
    run of addresses, with the most rows a thread, up to SCAN_RUN[L],
    that leave SCAN_MIN_TILES tiles, and a group's tiles chain by
    look-back.  Tile id is row block id // groups of column group id %
    groups (scan_tile)."""
    if n < 1 or C < 1:
        raise ValueError(f"gl_scan_mul: an array of shape ({n}, {C})")
    _field(L)
    if n <= SCAN_THREADS * SCAN_RUN[L]:
        cw = 1
        m = _pow2_at_least(-(-n // SCAN_THREADS))
    else:
        cw = min(_pow2_at_least(C), SCAN_MAX_COLS)
        fit = n * cw * -(-C // cw) // (SCAN_THREADS * SCAN_MIN_TILES)
        m = min(SCAN_RUN[L], _pow2_at_most(max(fit, 1)))
    R = m * SCAN_THREADS // cw
    return m, cw, R, -(-n // R), -(-C // cw)


def scan_tile(n: int, C: int, reverse: bool, table, tile: int):
    """The kernel's reading of tile `tile` of scan_tiles' table for an [n,
    C] call: (k, first logical row, rows, first physical row, first
    column, columns), k its row block in its group's scan order (0 the
    first: in reverse the last physical rows)."""
    _, cw, R, _, groups = table
    k, g = divmod(tile, groups)
    first = k * R
    rows = min(R, n - first)
    return (k, first, rows, n - first - rows if reverse else first,
            g * cw, min(cw, C - g * cw))


def scan_status_words(tiles: int, cw: int, L: int) -> int:
    """Words of gl_scan_mul's look-back state (scan_status_words in
    csrc/gl_scan.cu) for a launch of `tiles` tiles of cw columns: the tile
    counter's 8 words, a flag a tile rounded up to 8, then an aggregate and
    an inclusive prefix of cw elements (cw L words) a tile.  Only a call
    whose groups take more than one tile has one; the C entry zeroes it
    before the launch."""
    return 8 + -(-tiles // 8) * 8 + 2 * L * cw * tiles


def scan_launch(a, reverse: bool):
    """The running product along axis 0 of a CUDA [n, ..., L] tensor (L = 2
    or 6; from the end when reverse): one gl_scan_mul launch on
    scan_tiles' table, its look-back state allocated (and zeroed by the C
    entry) only where a column group takes more than one tile."""
    L = a.shape[-1]
    _field(L)
    k = _native.FIELD_KERNELS[L]
    entry = k["scan"]
    a = a.contiguous()
    out = torch.empty_like(a)
    for name, t in (("a", a), ("out", out)):
        _native.check_cuda_tensor(t, f"{entry} {name}", last_dim=L, align=8)
    n = a.shape[0]
    C = a.numel() // (L * n) if n else 0
    if C == 0:
        return out
    if C >= 1 << 31:
        raise ValueError(f"{entry}: {C} columns do not fit an int")
    m, cw, _, per_group, groups = scan_tiles(n, C, L)
    status = None
    if per_group > 1:
        status = torch.empty(scan_status_words(per_group * groups, cw, L),
                             dtype=torch.int32, device=a.device)
    _native.launch(entry, a.device, a.data_ptr(), n, C, int(reverse),
                   m.bit_length() - 1, cw.bit_length() - 1, *k["args"],
                   out.data_ptr(),
                   None if status is None else status.data_ptr())
    return out
