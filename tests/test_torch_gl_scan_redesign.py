"""The redesigned Goldilocks / GF(p^3) running product on the CPU, held
against the JAX package:

- gl_scan_mul's tile table (fields/gl_cuda.py scan_tiles, scan_tile):
  tiles of R rows across a column group of cw columns cover every (row,
  column) of an [n, C] call exactly once, at ragged n around a tile (1,
  31, R - 1, R, R + 1, 3R + 5) and C of 1, 3, 20 and 40 (wider than a
  tile's SCAN_MAX_COLS), in both directions, a group's tiles in scan
  order; a call whose columns fit one tile a group has no look-back;
- its constants, its status words and its tile decoding against the
  words csrc/gl_scan.cu reads;
- a plain model of the kernel's arithmetic on that table (each thread's
  run of m rows as two chains, the scan over a column's threads by warp
  shuffles and then warps, the tile's prefix as the look-back forms it
  from its predecessors' aggregates and the nearest inclusive prefix, the
  walk)
  against the JAX package's prefix_mul (sandstorm_tpu/fields/scan.py:88)
  over GL and GL3, both directions, at those shapes, with zeros in a
  column.

Inputs are made from seeds with numpy and handed to both packages as the
same u32 words.  Tolerance 0: the arithmetic is exact.  The kernel itself
runs only on the card (tests/test_torch_cuda.py, chip_smoke.py phase 3o).
"""

import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.fields.gl3 import GL3 as JG3
from sandstorm_tpu.fields.goldilocks import GL as JGL
from sandstorm_tpu.fields.scan import prefix_mul as jax_prefix_mul
from sandstorm_tpu_torch.fields import gl_cuda
from sandstorm_tpu_torch.fields.gl3 import GL3
from sandstorm_tpu_torch.fields.goldilocks import GL
from sandstorm_tpu_torch.fields.scan import prefix_mul

CPU = torch.device("cpu")
FIELDS = {2: (GL, JGL), 6: (GL3, JG3)}
GL_SCAN_CU = (Path(__file__).resolve().parent.parent / "sandstorm_tpu_torch"
              / "csrc" / "gl_scan.cu")
WIDTHS = [1, 3, 20, 40]


def _rows_a_tile(C, L):
    """R of a call whose groups take more than one tile."""
    return gl_cuda.scan_tiles(1 << 30, C, L)[2]


def _lengths(C, L):
    R = _rows_a_tile(C, L)
    return [1, 31, R - 1, R, R + 1, 3 * R + 5]


def _words(rng, n, C, L):
    """[n, C, L] u32 words of random canonical elements."""
    w = rng.integers(0, 1 << 32, size=(n, C, L), dtype=np.uint64)
    w[..., 1::2] %= 0xFFFFFFFF          # each hi word < 2^32 - 1: below p
    return w.astype(np.uint32)


# -- (a) the tile table -------------------------------------------------------

@pytest.mark.parametrize("L", [2, 6])
@pytest.mark.parametrize("C", WIDTHS)
def test_tiles_cover_every_element_once_in_scan_order(L, C):
    """Every (row, column) of an [n, C] call lies in exactly one tile of
    scan_tiles' table, in both directions; a tile holds at most
    SCAN_THREADS SCAN_RUN[L] elements, in at most SCAN_MAX_COLS columns
    and SCAN_MAX_RUN rows a thread; a group's tiles come in scan order
    (tile k + 1 of a group takes the logical rows after tile k's, and a
    larger id: in reverse the physical rows before them); a call whose n
    rows fit a tile has one tile a group."""
    E = gl_cuda.SCAN_THREADS * gl_cuda.SCAN_RUN[L]
    for n in _lengths(C, L):
        table = gl_cuda.scan_tiles(n, C, L)
        m, cw, R, per_group, groups = table
        assert m & (m - 1) == 0 and cw & (cw - 1) == 0
        assert m <= gl_cuda.SCAN_MAX_RUN and cw <= gl_cuda.SCAN_MAX_COLS
        assert R == m * gl_cuda.SCAN_THREADS // cw and R * cw <= E
        assert per_group == -(-n // R) and groups == -(-C // cw)
        if n <= E:
            assert per_group == 1
        else:
            assert cw == min(gl_cuda._pow2_at_least(C),
                             gl_cuda.SCAN_MAX_COLS)
        for reverse in (False, True):
            seen = np.zeros((n, C), dtype=np.int64)
            last = {}
            for tile in range(per_group * groups):
                k, first, rows, lo, c0, cols = gl_cuda.scan_tile(
                    n, C, reverse, table, tile)
                assert 0 < rows <= R and 0 < cols <= cw
                assert first == k * R and c0 % cw == 0
                assert lo == (n - first - rows if reverse else first)
                seen[lo:lo + rows, c0:c0 + cols] += 1
                g = c0 // cw
                if g in last:
                    pk, pid = last[g]
                    assert k == pk + 1 and tile > pid
                else:
                    assert k == 0
                last[g] = (k, tile)
            assert (seen == 1).all()
            if reverse:
                assert gl_cuda.scan_tile(n, C, True, table, 0)[3] + \
                    min(R, n) == n
    with pytest.raises(ValueError, match="shape"):
        gl_cuda.scan_tiles(0, C, L)


def test_status_words_count_the_tiles_columns():
    """scan_status_words: the counter's 8 words, a flag a tile rounded up
    to 8, an aggregate and an inclusive prefix of cw elements a tile."""
    assert gl_cuda.scan_status_words(1, 1, 2) == 8 + 8 + 4
    assert gl_cuda.scan_status_words(9, 4, 6) == 8 + 16 + 2 * 6 * 4 * 9
    assert gl_cuda.scan_status_words(1024, 1, 6) == 8 + 1024 + 12 * 1024


# -- (b) the constants the kernel reads -----------------------------------------

def test_scan_constants_match_the_kernel():
    """scan_tiles' constants, scan_status_words and scan_tile's decoding
    are the ones csrc/gl_scan.cu's gl_scan_mul reads: threads a block,
    columns a tile, rows a thread; the status layout (its word count by
    the kernel's own expression, then counter, flags, aggregates and
    inclusive prefixes at the offsets status_at gives); the tile id split
    into row block and column group, the tile's first logical and
    physical rows, and the launch's tile count and memset."""
    src = GL_SCAN_CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("SCAN_THREADS") == gl_cuda.SCAN_THREADS
    assert 1 << const("SCAN_LOG_THREADS") == gl_cuda.SCAN_THREADS
    assert const("SCAN_MAX_COLS") == gl_cuda.SCAN_MAX_COLS
    assert const("SCAN_MAX_RUN") == gl_cuda.SCAN_MAX_RUN
    body = re.search(r"scan_status_words\(\s*long long tiles, int cw, int W\)"
                     r" \{\s*return ([^;]+);", src)[1]
    expr = body.replace("2LL", "2").replace("/", "//")
    for tiles in (1, 7, 8, 9, 1024, 3001):
        for cw in (1, 4, 32):
            for L in (2, 6):
                want = gl_cuda.scan_status_words(tiles, cw, L)
                assert eval(expr, {"tiles": tiles, "cw": cw, "W": L}) == want
    assert ("const long long f = (tiles + 7) / 8 * 8, v = (long long)W * cw"
            " * tiles;\n  return {base, base + 8, base + 8 + f, base + 8 + f"
            " + v};") in src
    assert "const long long k = id / groups;" in src
    assert "const int c0 = (int)(id - k * groups) << lcw;" in src
    assert "const long long first = k * R;" in src
    assert "const long long lo = reverse ? n - first - rows : first;" in src
    assert "const int R = m << lp;" in src
    assert ("const long long R = (long long)(SCAN_THREADS >> lcw) << lm;"
            in src)
    assert "scan_status_words(tiles, 1 << lcw, Fd::W) * 4" in src
    assert "if (per_group > 1) {" in src


# -- (c) the kernel's arithmetic --------------------------------------------------

def _shfl_up(v, d):
    """Lane p takes lane p - d's value along dim 1 (its own below d)."""
    return torch.cat([v[:, :d], v[:, :-d]], dim=1)


def _col_scan(mul, one, g):
    """col_scan over dim 1 (a column's P threads) of g [tiles, P, ...,
    L]: the shuffle steps within each warp's lanes, then the warps'
    products scanned the same way and carried in -> (ex, the products
    before each thread; tot, the column's product)."""
    P = g.shape[1]
    pl = min(P, 32)
    shape = (1, P) + (1,) * (g.dim() - 2)
    pos = (torch.arange(P) % pl).reshape(shape)
    v = g
    d = 1
    while d < pl:
        v = torch.where(pos >= d, mul(_shfl_up(v, d), v), v)
        d <<= 1
    ex = torch.where(pos == 0, one, _shfl_up(v, 1))
    if P > 32:
        wp = P // 32
        s = v[:, 31::32]
        wpos = torch.arange(wp).reshape((1, wp) + (1,) * (g.dim() - 2))
        d = 1
        while d < wp:
            s = torch.where(wpos >= d, mul(_shfl_up(s, d), s), s)
            d <<= 1
        w = torch.arange(P) // 32
        c = s[:, (w - 1).clamp(min=0)]
        has = (w > 0).reshape(shape)
        v = torch.where(has, mul(c, v), v)
        ex = torch.where(has & (pos == 0), c,
                         torch.where(has, mul(c, ex), ex))
    return ex, v[:, P - 1]


def _table(n, C, L, tile=None):
    """scan_tiles' table for an [n, C] call, or the one gl_cuda.scan_launch
    builds for a tile (m, cw) it is given."""
    if tile is None:
        return gl_cuda.scan_tiles(n, C, L)
    m, cw = tile
    R = m * gl_cuda.SCAN_THREADS // cw
    return m, cw, R, -(-n // R), -(-C // cw)


def _kernel_model(F, x, reverse, rng, tile=None):
    """gl_scan_mul's arithmetic on scan_tiles' table (or on the table of a
    tile (m, cw)) in plain ops, for an [n, C, L] CPU tensor: each tile's
    logical rows gathered by scan_tile
    (ones past the array), thread p of column c taking rows p m ... p m +
    m - 1; the product of its rows as two chains (rows below h = (m + 1)
    // 2 and the rest); col_scan's exclusive prefix of each thread and
    the tile column's product A; the tile's prefix, the product of its
    group's earlier tiles as the look-back forms it (the aggregates of
    the nearest predecessors back to one whose inclusive prefix it
    takes, at a depth drawn from rng), times each thread's prefix; the
    walk, both chains, the second from the prefix times the first
    chain's product."""
    n, C, L = x.shape
    mul = gl_cuda.plain_ops(L)[2]
    one = F.ones((1,), CPU)[0]
    table = _table(n, C, L, tile)
    m, cw, R, per_group, groups = table
    P = gl_cuda.SCAN_THREADS // cw
    X = one.expand(per_group, R, groups, cw, L).clone()
    V = torch.zeros(per_group, R, groups, cw, 1, dtype=torch.bool)
    tiles = [gl_cuda.scan_tile(n, C, reverse, table, t)
             for t in range(per_group * groups)]
    for k, _, rows, lo, c0, cols in tiles:
        blk = x[lo:lo + rows, c0:c0 + cols]
        X[k, :rows, c0 // cw, :cols] = blk.flip(0) if reverse else blk
        V[k, :rows, c0 // cw, :cols] = True
    # threads: [row block, P, m, group, column, L]
    X = X.reshape(per_group, P, m, groups, cw, L)
    V = V.reshape(per_group, P, m, groups, cw, 1)
    h = (m + 1) // 2
    g = [one.expand(per_group, P, groups, cw, L)] * 2
    for i in range(m):
        c, j = divmod(i, h)
        g[c] = torch.where(V[:, :, i], X[:, :, i] if j == 0
                           else mul(g[c], X[:, :, i]), g[c])
    g0, g = g[0], mul(g[0], g[1])
    ex, A = _col_scan(mul, one, g)
    inc = []
    for k in range(per_group):
        if k == 0:
            inc.append(A[0])
            continue
        stop = rng.randrange(min(k, 3))   # the nearest inclusive prefix met
        pre = inc[k - 1 - stop]
        for d in range(stop):
            pre = mul(pre, A[k - 1 - d])
        ex[k] = mul(pre[None], ex[k])
        inc.append(mul(pre, A[k]))
    Y = X.clone()
    acc = [ex, mul(ex, g0)]
    for i in range(m):
        c = i // h
        nxt = mul(acc[c], X[:, :, i])
        acc[c] = torch.where(V[:, :, i], nxt, acc[c])
        Y[:, :, i] = torch.where(V[:, :, i], nxt, X[:, :, i])
    Y = Y.reshape(per_group, R, groups, cw, L)
    out = torch.empty_like(x)
    for k, _, rows, lo, c0, cols in tiles:
        blk = Y[k, :rows, c0 // cw, :cols]
        out[lo:lo + rows, c0:c0 + cols] = blk.flip(0) if reverse else blk
    return out


def _jax_scans(JF, L, arrays, reverse):
    """The JAX package's prefix_mul of each [n, C, L] u32 array, from one
    call: the arrays side by side in one array of the longest length, an
    array's rows at the top (forward) or the bottom (reverse), the rest
    ones, so each array's rows see only their own products."""
    N = max(w.shape[0] for w in arrays)
    one = np.array([1] + [0] * (L - 1), dtype=np.uint32)
    big = np.broadcast_to(one, (N, sum(w.shape[1] for w in arrays), L)).copy()
    at, spans = 0, []
    for w in arrays:
        n, C = w.shape[:2]
        rows = slice(N - n, N) if reverse else slice(0, n)
        big[rows, at:at + C] = w
        spans.append((rows, slice(at, at + C)))
        at += C
    got = np.asarray(jax_prefix_mul(JF, jnp.asarray(big), reverse))
    return [got[r, c] for r, c in spans]


# (n, C, tile) of the model's cases: n around a tile's rows R, at each width
# in WIDTHS; on scan_tiles' table (tile None: a column a tile where n rows
# fit SCAN_THREADS SCAN_RUN[L] elements) and on tiles of 1 row a thread,
# whose groups chain by look-back from 2 tiles up (R = 256 / cw: 256, 64,
# 8 and 8 rows at C = 1, 3, 20, 40).  The JAX package's GF(p^3) scan costs
# about 0.1 ms an element and stage on the CPU, so over GF(p^3) only
# _jax_buckets' cases go to it; every case is also held to the port's
# plain prefix_mul, which test_torch_gl_kernels.py holds to JAX
def _model_cases(L):
    cases = []
    for C in WIDTHS:
        cw = min(gl_cuda._pow2_at_least(C), gl_cuda.SCAN_MAX_COLS)
        R = gl_cuda.SCAN_THREADS // cw
        cases += [(n, C, (1, cw)) for n in (R - 1, R, R + 1, 3 * R + 5)]
        cases += [(n, C, None) for n in (1, 31, 257)]
    return cases


def _jax_buckets(L, cases):
    """The cases held to the JAX package, in calls of similar lengths (a
    call's cost is its longest length times its columns): over GL every
    case; over GF(p^3) the chained tiles at 3 and 40 columns up to R + 1
    rows and the one-tile lengths 1 and 31 at 1 and 3 columns."""
    keep = [i for i, (w, tile) in enumerate(cases)
            if L == 2 or (w.shape[1] in (3, 40) and tile is not None
                          and w.shape[0] <= 65)
            or (w.shape[1] in (1, 3) and tile is None and w.shape[0] <= 31)]
    short = [i for i in keep if cases[i][0].shape[0] <= 9]
    return [short, [i for i in keep if i not in short]]


@pytest.mark.parametrize("L", [2, 6])
def test_kernel_model_matches_jax_prefix_mul(L):
    """The model of gl_scan_mul on its tile tables equals the JAX package's
    prefix_mul, both directions, at _model_cases' shapes (GF(p^3): those
    _jax_buckets keeps), with a zero mid-column in the last column and
    one at the second tile's first row in the first; and the port's own
    CPU prefix_mul at every case."""
    F, JF = FIELDS[L]
    rng = np.random.default_rng(L)
    prng = random.Random(L)
    cases = []
    for n, C, tile in _model_cases(L):
        w = _words(rng, n, C, L)
        w[n // 2, C - 1] = 0
        w[min(_table(n, C, L, tile)[2], n - 1), 0] = 0
        cases.append((w, tile))
    for reverse in (False, True):
        want = {}
        for bucket in _jax_buckets(L, cases):
            want.update(zip(bucket, _jax_scans(
                JF, L, [cases[i][0] for i in bucket], reverse)))
        for i, (w, tile) in enumerate(cases):
            t = torch.from_numpy(w.view(np.int32))
            got = _kernel_model(F, t, reverse, prng, tile)
            n, C = w.shape[:2]
            if i in want:
                assert np.array_equal(got.numpy().view(np.uint32),
                                      want[i]), (n, C, tile, reverse)
            assert torch.equal(got, prefix_mul(F, t, reverse)), (n, C, tile)
