"""The redesigned Goldilocks / GF(p^3) batch inversion and DEEP on the CPU,
held against the JAX package:

- gl_batch_inv's tile table (fields/gl_cuda.py inv_segments, inv_tile):
  tiles that span a segment's columns, column groups past a tile's width,
  each column's flag word, at ragged lengths over several segments of 1
  and 3 columns, against the words csrc/gl_scan.cu reads; and a model of
  the kernel's arithmetic on that table (Montgomery's trick within each
  tile, two chains a thread, the block pass over the chains' norms in
  GF(p), one inversion a tile column, the flagged columns zeroed after
  the last tile) against GL.batch_inv / GL3.batch_inv, a zero in one tile
  of many included;
- deep_prepare's base-first column order and nbase over GF(p^3) at the
  plain layout's 20 points and 50 terms: the prepared tables applied in
  plain ops (prover.deep_launch_plain, the kernel's contract) equal the
  JAX package's _deep_compose, and a column named base that is not
  base-field is refused;
- the plain models of the device inversion (gl::inv, its addition chain;
  over GF(p^3) the Frobenius-and-norm route of gl3::norm) against GL.inv
  / GL3.inv at 0, 1, p - 1 and random values.

Inputs are made from seeds and handed to both packages as the same u32
words.  Tolerance 0: the arithmetic is exact.  The kernels themselves run
only on the card (tests/test_torch_cuda.py, chip_smoke.py phase 3o).
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
from sandstorm_tpu.stark import prover as jprover
from sandstorm_tpu_torch.air.expr import trace_arguments
from sandstorm_tpu_torch.fields import gl_cuda
from sandstorm_tpu_torch.fields.gl3 import GL3
from sandstorm_tpu_torch.fields.goldilocks import GL
from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
from sandstorm_tpu_torch.stark import prover

CPU = torch.device("cpu")
P = GL.MODULUS
FIELDS = {"goldilocks": (GL, JGL), "gl3": (GL3, JG3)}
GL_SCAN_CU = (Path(__file__).resolve().parent.parent / "sandstorm_tpu_torch"
              / "csrc" / "gl_scan.cu")


def _ints(F, rng, count):
    return [rng.randrange(F.MODULUS) for _ in range(count)]


def _jax(F, JF, t):
    """The port's words as a JAX array of the same u32 words."""
    return jnp.asarray(t.numpy().view(np.uint32))


def _agree(jax_arr, port_t):
    return np.array_equal(np.asarray(jax_arr), port_t.numpy().view(np.uint32))


# -- (a) the tile table -------------------------------------------------------

def test_tile_constants_match_the_kernel():
    """inv_segments' constants and word layout are the ones
    csrc/gl_scan.cu's gl_batch_inv reads: threads a block, words a segment
    row, segments a launch, rows a thread (InvRows<GLF> / <GL3F>), and the
    words of a segment row it takes for n, C, R, cw, the first tile and the
    first column's flag."""
    src = GL_SCAN_CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("INV_THREADS") == gl_cuda.INV_THREADS
    assert const("INV_SEG") == gl_cuda.INV_SEG
    assert const("INV_MAX_SEGS") == gl_cuda.INV_MAX_SEGS
    for fd, L in (("GLF", 2), ("GL3F", 6)):
        m = re.search(rf"struct InvRows<{fd}> {{\s*static constexpr int M = "
                      rf"(\d+);", src)
        assert int(m[1]) * gl_cuda.INV_THREADS == gl_cuda.INV_ROWS[L]
    assert "const long long n = S[2], C = S[3], R = S[4], cw = S[5];" in src
    assert "k = id - S[6];" in src
    assert "scratch[1 + S[7] + c0 + c] = 1;" in src
    assert "segs.w[(s + 1) * INV_SEG + 6] <= id" in src


SHAPES = [(1, 1), (31, 3), (2047, 1), (2049, 3), (4097, 1), (5000, 3),
          (257, 20), (3, 40)]


@pytest.mark.parametrize("L", [2, 6])
def test_tiles_cover_every_element_once(L):
    """Over segments of ragged lengths with 1, 3, 20 and 40 columns: every
    (segment, row, column) lies in exactly one tile; a tile spans all of
    its segment's columns where INV_THREADS rows of each fit, else a
    column group of INV_ROWS[L] // INV_THREADS; no tile holds more than
    INV_ROWS[L] elements or more rows than a thread's registers cover
    (INV_ROWS[L] // INV_THREADS a thread); a segment's tiles are
    consecutive ids from its first tile; each column's flag word is its
    own, 1 + the launch's running column index."""
    segs, ntiles, ncols = gl_cuda.inv_segments(SHAPES, L)
    E, T = gl_cuda.INV_ROWS[L], gl_cuda.INV_THREADS
    assert segs.shape == (len(SHAPES), gl_cuda.INV_SEG)
    assert ncols == sum(C for _, C in SHAPES)
    seen = {}
    flags = {}
    for tile in range(ntiles):
        s, r0, rows, c0, cols, fl = gl_cuda.inv_tile(segs, tile)
        n, C = SHAPES[s]
        assert 0 < rows and r0 + rows <= n and 0 < cols and c0 + cols <= C
        assert rows * cols <= E and rows <= E
        if C * T <= E:
            assert (c0, cols) == (0, C)
        else:
            assert cols <= E // T and c0 % (E // T) == 0
        for c, f in zip(range(c0, c0 + cols), fl):
            assert flags.setdefault((s, c), f) == f
            for r in range(r0, r0 + rows):
                assert (s, r, c) not in seen
                seen[(s, r, c)] = tile
    assert len(seen) == sum(n * C for n, C in SHAPES)
    first = np.cumsum([0] + [C for _, C in SHAPES])
    assert sorted(flags.values()) == list(range(1, ncols + 1))
    for (s, c), f in flags.items():
        assert f == 1 + first[s] + c
    # a segment's tiles are consecutive from its first tile
    by_seg = {}
    for (s, _, _), tile in seen.items():
        by_seg.setdefault(s, set()).add(tile)
    for s, tiles in by_seg.items():
        assert tiles == set(range(int(segs[s, 6]), int(segs[s, 6]) +
                                  len(tiles)))
    with pytest.raises(ValueError, match="segments a launch"):
        gl_cuda.inv_segments([(1, 1)] * (gl_cuda.INV_MAX_SEGS + 1), L)
    with pytest.raises(ValueError, match="segment of shape"):
        gl_cuda.inv_segments([(0, 1)], L)


def _norm(F, g):
    """(N(g), t) with g^-1 = t N(g)^-1: gl3::norm's route (t = g^p
    g^(p^2), N(g) = g t in GF(p)); over GL (g, 1)."""
    if F.NLIMBS == 2:
        return int(g), F.s(1)
    t = g.frob() * g.frob().frob()
    n = (g * t).c
    assert n[1] == n[2] == 0
    return n[0], t


def _tile_model(F, arrays):
    """The kernel's arithmetic on inv_segments' table in python field
    scalars: per tile and column, thread t's rows t, t + INV_THREADS, ...
    as two chains (its even and its odd rows) with the products of each
    row's chain before it (pre) and each chain's product g; the block pass
    over the norms N(g0) N(g1) in GF(p) (the products of the threads
    before (x) and after (y) each, and G, inverted: 0 for 0, the column's
    flag set); each chain's g^-1 = t (G^-1 x y N(other chain)); the walk
    back; after the last tile every flagged column zeroed."""
    L = F.NLIMBS
    T = gl_cuda.INV_THREADS
    shapes = [(a.shape[0], a.numel() // (L * a.shape[0])) for a in arrays]
    segs, ntiles, ncols = gl_cuda.inv_segments(shapes, L)
    vals = [[F.s(v) for v in F.decode_ints(a.reshape(-1, L))] for a in arrays]
    outs = [[None] * len(v) for v in vals]
    flag = [0] * (1 + ncols)
    one = F.s(1)
    for tile in range(ntiles):
        s, r0, rows, c0, cols, fl = gl_cuda.inv_tile(segs, tile)
        C = shapes[s][1]
        for c, f in zip(range(c0, c0 + cols), fl):
            a = [vals[s][(r0 + i) * C + c] for i in range(rows)]
            chains = [[list(range(t, rows, T))[k::2] for k in (0, 1)]
                      for t in range(T)]
            pre, g, norms = {}, [], []
            for t in range(T):
                gt = []
                for chain in chains[t]:
                    acc = one
                    for i in chain:
                        pre[i] = acc
                        acc = acc * a[i] % F.MODULUS
                    gt.append(acc)
                nt = [_norm(F, v) for v in gt]
                g.append(nt)
                norms.append(nt[0][0] * nt[1][0] % P)
            G = 1
            for v in norms:
                G = G * v % P
            Ginv = pow(G, P - 2, P)
            if G == 0:
                flag[f] = 1
            for t in range(T):
                x = y = 1
                for v in norms[:t]:
                    x = x * v % P
                for v in norms[t + 1:]:
                    y = y * v % P
                q = Ginv * x % P * y % P
                (n0, t0), (n1, t1) = g[t]
                for k, (tk, other) in enumerate(((t0, n1), (t1, n0))):
                    acc = tk * F.s(q * other % P) % F.MODULUS
                    for i in reversed(chains[t][k]):
                        outs[s][(r0 + i) * C + c] = acc * pre[i] % F.MODULUS
                        acc = acc * a[i] % F.MODULUS
    first = np.cumsum([0] + [C for _, C in shapes])
    for s, (n, C) in enumerate(shapes):
        for c in range(C):
            if flag[1 + first[s] + c]:
                for r in range(n):
                    outs[s][r * C + c] = F.s(0)
    return [F.encode_ints([int(v) for v in o], CPU).reshape(a.shape)
            for o, a in zip(outs, arrays)]


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_tile_model_matches_jax_with_a_zero_in_one_tile(name):
    """The model of the kernel's arithmetic on its tile table equals the
    JAX package's GL.batch_inv / GL3.batch_inv, array by array, over a
    call of 1- and 3-column segments whose 3-column one spans several
    tiles: a single zero in one tile of a column gives that column all
    zeros, in every tile, and leaves its neighbours their inverses; a
    zero in a one-tile segment likewise."""
    F, JF = FIELDS[name]
    rng = random.Random(len(name))
    E = gl_cuda.INV_ROWS[F.NLIMBS]
    n3 = E // 3 * 2 + 5           # three row blocks of a 3-column segment
    shapes = [(1,), (5, 3), (n3, 3), (E + 3,)]
    arrays = [F.encode_ints(_ints(F, rng, int(np.prod(sh))), CPU)
              .reshape(sh + (F.NLIMBS,)) for sh in shapes]
    arrays[2][E // 3 + 7, 1] = 0   # the second tile of column 1
    arrays[1][4, 0] = 0
    got = _tile_model(F, arrays)
    for a, g in zip(arrays, got):
        assert _agree(JF.batch_inv(_jax(F, JF, a)), g)
    assert not got[2][:, 1].any() and got[2][:, 0].any(dim=-1).all() \
        and got[2][:, 2].any(dim=-1).all()
    assert not got[1][:, 0].any() and got[1][:, 1:].any(dim=-1).all()
    assert torch.equal(got[3], gl_cuda.batch_inv_plain(arrays[3]))


# -- (b) deep_prepare's base-first order and its contract ---------------------

def _plain_deep_case(F, n=16, blowup=2, seed=5):
    """The plain layout's trace arguments (20 points, 50 terms) over seeded
    columns of the field, its 5 main columns base-field values, and the
    JAX package's _deep_compose of the same inputs."""
    JF = FIELDS[F.NAME][1]
    N = n * blowup
    rng = random.Random(seed)
    g = F.root_of_unity_int(n)
    targs = trace_arguments(PlainAirConfig.constraints(
        n, F.MODULUS, g, base_modulus=P))
    nb = PlainAirConfig.NUM_BASE_COLUMNS
    ncols = 1 + max(c for c, _ in targs)
    vals = {c: [rng.randrange(P) if c < nb else rng.randrange(F.MODULUS)
                for _ in range(N)] for c in range(ncols)}
    comp = [_ints(F, rng, N) for _ in range(2)]
    tv, cv = _ints(F, rng, len(targs)), _ints(F, rng, 2)
    z, alpha = _ints(F, rng, 2)
    args = (targs, {c: F.encode_ints(v, CPU) for c, v in vals.items()},
            [F.encode_ints(v, CPU) for v in comp], tv, cv, z, g, n, alpha)
    jdom = jprover._DomainCache(JF, N, JF.GENERATOR)
    want = jprover._deep_compose(
        JF, jdom, targs, {c: JF.encode_ints(v) for c, v in vals.items()},
        [JF.encode_ints(v) for v in comp], tv, cv, z, g, n, alpha)
    dom = prover._DomainCache(F, N, F.GENERATOR, CPU)
    return args, dom, nb, np.asarray(want)


@pytest.mark.parametrize("name", ["gl3", "goldilocks"])
def test_deep_prepare_orders_base_columns_first(name):
    """deep_prepare with the prove's base columns named: nbase = 5, the
    five base LDE columns first in key order (the very tensors), then the
    extension column and the two composition columns; every term on a
    base column indexes below nbase; the plain layout's 20 points and 50
    terms; the scalars in the kernel's form (GF(p^3): c0, c1, c2, 2 c1,
    2 c2 a term).  Applied in plain ops (deep_launch_plain: a base column
    read as its c0 word) the tables give the JAX package's _deep_compose,
    as they do with no base column named; read with one base column too
    many they give another result."""
    F, _ = FIELDS[name]
    args, dom, nb, want = _plain_deep_case(F)
    targs, cols = args[0], args[1]
    prep = prover.deep_prepare(F, dom, *args, base_cols=range(nb))
    assert prep["nbase"] == nb
    assert all(prep["cols"][c] is cols[c] for c in range(nb))
    assert (prep["points"], prep["terms"]) == (20, 50)
    ncols = len(prep["cols"])
    meta = prep["meta"].tolist()
    term_col = meta[2 * ncols:2 * ncols + prep["terms"]]
    bases = {id(cols[c]) for c in range(nb)}
    for j in term_col:
        assert (j < nb) == (id(prep["cols"][j]) in bases)
    assert sum(1 for j in term_col if j < nb) == sum(
        1 for c, _ in targs if c < nb)
    words = prep["vals"].numpy().view(np.uint64)
    U = 5 if F.NLIMBS == 6 else 1
    assert words.size == prep["terms"] * U + prep["points"] * (F.NLIMBS // 2)
    if U == 5:
        terms = words[:prep["terms"] * 5].reshape(-1, 5).astype(object)
        assert all(int(w[3]) == 2 * int(w[1]) % P and
                   int(w[4]) == 2 * int(w[2]) % P for w in terms)
    got = prover.deep_launch_plain(F, prep)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    prep0 = prover.deep_prepare(F, dom, *args)
    assert prep0["nbase"] == 0
    assert np.array_equal(prover.deep_launch_plain(F, prep0).numpy()
                          .view(np.uint32), want)
    if F.NLIMBS == 6:
        prep["nbase"] = nb + 1       # the extension column read as base
        assert not np.array_equal(prover.deep_launch_plain(F, prep).numpy()
                                  .view(np.uint32), want)


def test_deep_prepare_refuses_a_non_embedded_base_column():
    """A column named base whose upper coordinates are not zero is refused
    over GF(p^3), as check_base_embedded refuses it; base keys that no
    term names are left out; over Goldilocks every column is one word."""
    args, dom, nb, _ = _plain_deep_case(GL3)
    with pytest.raises(ValueError, match="nonzero upper"):
        prover.deep_prepare(GL3, dom, *args, base_cols=range(nb + 1))
    prep = prover.deep_prepare(GL3, dom, *args,
                               base_cols=list(range(nb)) + [99])
    assert prep["nbase"] == nb
    gargs, gdom, _, _ = _plain_deep_case(GL)
    assert prover.deep_prepare(GL, gdom, *gargs,
                               base_cols=range(nb + 1))["nbase"] == nb + 1


# -- (c) the device inversions' plain models ----------------------------------

@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_inversion_models_match_jax(name):
    """gl_cuda.gl_inv_plain (gl::inv's addition chain) and gl3_inv_plain
    (gl3::norm's Frobenius scalings and norm, gl::inv of it, one product by
    t) equal the JAX package's GL.inv / GL3.inv at 0, 1, p - 1,
    coordinates at p - 1 and near 2^64, and random values."""
    F, JF = FIELDS[name]
    rng = random.Random(11)
    vals = [0, 1, 2, P - 1, P - 2, 1 << 63, (1 << 32) - 1]
    if F.NLIMBS == 6:
        vals += [P, P * P, F.MODULUS - 1, (P - 1) * (1 + P),
                 (P - 1) * P * P, F.MODULUS - 2]
    vals += _ints(F, rng, 12)
    t = F.encode_ints(vals, CPU)
    model = gl_cuda.gl_inv_plain if F.NLIMBS == 2 else gl_cuda.gl3_inv_plain
    got = model(t)
    assert _agree(JF.inv(_jax(F, JF, t)), got)
    assert torch.equal(got, F.inv(t))
    assert not got[0].any()
