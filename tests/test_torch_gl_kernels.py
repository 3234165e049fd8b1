"""The Goldilocks and GF(p^3) kernels' route of phases 4 to 6 on the CPU:
each plain version against the JAX package, over GL and over GL3.

- the constraint groups' interpreter (air/expr.py evaluate_lde_folded,
  the programs of air/codegen.py rendered for the field) against the JAX
  package's eager evaluate_lde folded with the same coefficients (the
  route the JAX package runs off its chip: its grouped jit over GL3
  compiles for too long on XLA:CPU), on the DAGs of
  test_torch_fused_eval.py and on the plain layout at a tiny N;
- the running product and the batch inversion (fields/scan.py prefix_mul,
  batch_inv_many: on the CPU gl_scan_mul's and gl_batch_inv's plain
  versions, fields/gl_cuda.py), zero columns included, against
  sandstorm_tpu's prefix_mul and GL.batch_inv / GL3.batch_inv, and the
  plain version's inversion of the totals against the field's (the
  redesigned kernel's table and arithmetic: test_torch_gl_redesign.py);
- the shifted-denominator DEEP (stark/prover.py _deep_shifted, the plain
  version of gl_deep_compose) against the JAX package's _deep_compose,
  with negative offsets and offsets of a trace length and more;
- the dense opener's plain version (open_dense_plain, the plain version
  of the pair-indexed gl_open_pairs) against _open_all_at_point;
- the three host paths that a packed GF(p^3) int would break (the scalar
  subtrees, the fold coefficients, DEEP's coefficients and points), each
  with a case that the integer arithmetic gets wrong;
- the tiny GL, GL3 and goldilocks_cairo proofs through the kernels' route
  (its plain versions) equal TINY_SHA256.

Inputs are made from seeds and handed to both packages as the same u32
words (GL [..., 2], GL3 [..., 6]).  Tolerance 0: the arithmetic is exact.
The kernels live only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold them to these plain versions there.
"""

import functools
import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TINY_SHA256
from sandstorm_tpu.air import expr as JE
from sandstorm_tpu.fields.gl3 import GL3 as JG3
from sandstorm_tpu.fields.gl3 import Fq3S as JFq3S
from sandstorm_tpu.fields.goldilocks import GL as JGL
from sandstorm_tpu.fields.scan import prefix_mul as jax_prefix_mul
from sandstorm_tpu.stark import prover as jprover
from sandstorm_tpu_torch.air import codegen
from sandstorm_tpu_torch.air import expr as E
from sandstorm_tpu_torch.fields import gl_cuda
from sandstorm_tpu_torch.fields.gl3 import GL3, Fq3S
from sandstorm_tpu_torch.fields.goldilocks import GL
from sandstorm_tpu_torch.fields.scan import (batch_inv_many, prefix_mul,
                                             prefix_scan)
from sandstorm_tpu_torch.stark import openings, prover

CPU = torch.device("cpu")
P = GL.MODULUS
FIELDS = {"goldilocks": (GL, JGL), "gl3": (GL3, JG3)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ints(F, rng, count):
    return [rng.randrange(F.MODULUS) for _ in range(count)]


def _both(F, JF, vals, shape=None):
    """The same elements as a JAX array and a port tensor."""
    words = F.encode_ints_np(vals)
    if shape is not None:
        words = words.reshape(tuple(shape) + (F.NLIMBS,))
    return jnp.asarray(words.view(np.uint32)), torch.from_numpy(words)


def _agree(jax_arr, port_t):
    return np.array_equal(np.asarray(jax_arr), port_t.numpy().view(np.uint32))


# -- the constraint groups ----------------------------------------------------

def _dags(N, which):
    """test_torch_fused_eval.py's DAGs in both packages' nodes, and one
    with scalar subtrees (products and an inverse of challenges, a
    constant quotient) that the host evaluates."""
    out = []
    for M in (JE, E):
        t0, t1 = M.Trace(0, 0), M.Trace(1, 1)
        if which == "folded":
            exprs = [t0 * t1 - M.Challenge(0),
                     (t0.pow(2) - t1) / (M.X.pow(N // 4) - 1),
                     M.X * t1 + t0, t1 - 3, (t0 - t1).pow(3)]
        elif which == "chunked":
            zer_short = M.X.pow(N // 8) - 1
            zer_long = M.X.pow(3) - 7
            exprs = [(t0 * t1 - M.Challenge(0)) / zer_short,
                     (t0.pow(2) - t1) / zer_short,
                     M.X * t1 + t0 / zer_long, t1.pow(3) - t0]
        elif which == "negative":
            tm, tw = M.Trace(1, -3), M.Trace(0, -N)
            exprs = [tm * t0 - M.Challenge(0),
                     (tw - tm.pow(2)) / (M.X - 5) + M.X.pow(N // 2),
                     -tm * M.Challenge(0) * M.Challenge(0) - M.Constant(5)
                     / M.Constant(7),
                     (tm + t1) / (M.X.pow(N // 8) - 1)]
        else:   # scalars
            c0, c1 = M.Challenge(0), M.Challenge(1)
            exprs = [t0 * (c0 * c1 + 3) - t1,
                     t1 * (M.Constant(1) / c0) + c0.pow(5) - 7,
                     (t0 - c1 * c1 * c0) / (M.X.pow(N // 4) - c0 * c1)]
        out.append(exprs)
    return out


def _jax_eager_fold(JF, jexprs, jctx, N, coeffs):
    def fold(acc, v, i):
        c = JF.encode_int(int(coeffs[i]))
        t = JF.mul(v, jnp.broadcast_to(c, v.shape))
        return t if acc is None else JF.add(acc, t)
    return JE.evaluate_lde(jexprs, jctx, domain_size=N, fold=fold)


def _fold_case(name, which, N, blowup=2, seed=0):
    """(jax result, port tensor whole, port tensor in windows of N / 4) of
    the fold of a DAG over seeded columns in field `name`; GF(p^3) runs
    with base-field trace columns (as a GF(p^3) prove's base columns) and
    one full extension column."""
    F, JF = FIELDS[name]
    rng = random.Random(seed + len(which) + (7 if name == "gl3" else 0))
    coset = F.GENERATOR
    cols = [[rng.randrange(P) for _ in range(N)],
            _ints(F, rng, N)]
    ch = _ints(F, rng, 2)
    jexprs, texprs = _dags(N, which)
    alpha = F.s(_ints(F, rng, 1)[0])
    coeffs = [alpha ** (i + 1) for i in range(len(texprs))]
    jdom = jprover._DomainCache(JF, N, coset)
    jctx = JE.LdeContext(JF, {i: JF.encode_ints(c) for i, c in
                              enumerate(cols)}, blowup, jdom.domain,
                         jdom.x_pow,
                         challenges=[JF.encode_int(c) for c in ch],
                         coset=coset)
    want = _jax_eager_fold(JF, jexprs, jctx, N, coeffs)
    dom = prover._DomainCache(F, N, coset, CPU)
    tctx = E.LdeContext(F, {i: F.encode_ints(c, CPU) for i, c in
                            enumerate(cols)}, blowup, dom.domain, dom.x_pow,
                        challenges=[F.encode_int(c, CPU) for c in ch])
    whole = E.evaluate_lde_folded(texprs, tctx, N, coeffs, group_size=2)
    windows = E.evaluate_lde_folded(texprs, tctx, N, coeffs, group_size=2,
                                    chunk_size=N // 4)
    return want, whole, windows


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("which,N", [("folded", 32), ("chunked", 64),
                                     ("negative", 64), ("scalars", 32)])
def test_interpreter_matches_jax_eager_fold(name, which, N):
    """The group programs' interpreter (group size 2), over the whole
    domain and in windows, equals the JAX package's eager evaluate_lde
    folded with the same coefficients, in GL and in GF(p^3)."""
    want, whole, windows = _fold_case(name, which, N)
    assert _agree(want, whole)
    assert torch.equal(whole, windows)


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_plain_layout_fold_matches_jax_eager(name):
    """The plain layout's 47 constraints at n = 16, blowup 2, with the
    field's own constants (constraints(n, F.MODULUS, g)), seeded columns
    (base-field trace values; the extension column full), challenges and
    hints: the interpreter of the plan lowered for the field equals the
    JAX package's eager fold."""
    from sandstorm_tpu.layouts.plain.air import PlainAirConfig as JA
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig as TA
    F, JF = FIELDS[name]
    n, blowup = 16, 2
    N, coset = n * blowup, F.GENERATOR
    rng = random.Random(41)
    g = F.root_of_unity_int(n)
    tcons = TA.constraints(n, F.MODULUS, g, base_modulus=P)
    leaves = [nd.key for nd in E.walk(tcons)]
    ncols = 1 + max(k[1] for k in leaves if k[0] == "trace")
    vals = {c: [rng.randrange(P) for _ in range(N)] for c in range(ncols)}
    vals[ncols - 1] = _ints(F, rng, N)
    ch = _ints(F, rng, 1 + max(k[1] for k in leaves if k[0] == "challenge"))
    hints = _ints(F, rng, 1 + max(k[1] for k in leaves if k[0] == "hint"))
    alpha = F.s(_ints(F, rng, 1)[0])
    coeffs = [alpha ** i for i in range(len(tcons))]
    dom = prover._DomainCache(F, N, coset, CPU)
    tctx = E.LdeContext(F, {c: F.encode_ints(v, CPU)
                            for c, v in vals.items()}, blowup, dom.domain,
                        dom.x_pow,
                        challenges=[F.encode_int(c, CPU) for c in ch],
                        hints=[F.encode_int(h, CPU) for h in hints])
    got = E.evaluate_lde_folded(tcons, tctx, N, coeffs)
    plan = codegen.lower(tcons, N, [], 8, F.NAME)
    assert plan.field == F.NAME and len(plan.groups) == -(-len(tcons) // 8)
    jdom = jprover._DomainCache(JF, N, coset)
    jctx = JE.LdeContext(JF, {c: JF.encode_ints(v) for c, v in vals.items()},
                         blowup, jdom.domain, jdom.x_pow,
                         challenges=[JF.encode_int(c) for c in ch],
                         hints=[JF.encode_int(h) for h in hints],
                         coset=coset)
    want = _jax_eager_fold(JF, JA.constraints(n, F.MODULUS, g,
                                              base_modulus=P),
                           jctx, N, coeffs)
    assert _agree(want, got)


def test_group_sources_differ_by_field_and_keep_fp252():
    """The plain layout's DAG rendered for GL, GL3 and Fp252: three
    sources and three stems (the field is part of the plan); the GL and
    GL3 sources read through goldilocks.cuh's field interface, and the
    Fp252 one still through fp252.cuh, as before (its stem is pinned in
    chip_smoke's build_air line through air_plan)."""
    from sandstorm_tpu_torch.fields.fp252 import Fp252
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    n = 1 << 10
    cons = PlainAirConfig.constraints(n, P, GL.root_of_unity_int(n),
                                      base_modulus=P)
    plans = {f: codegen.lower(cons, 2 * n, [], 8, f)
             for f in ("goldilocks", "gl3", "fp252")}
    assert len({pl.stem for pl in plans.values()}) == 3
    assert len({pl.source for pl in plans.values()}) == 3
    assert "using Fd = GLF;" in plans["goldilocks"].source
    assert "using Fd = GL3F;" in plans["gl3"].source
    for f in ("goldilocks", "gl3"):
        src = plans[f].source
        assert '#include "goldilocks.cuh"' in src and "fp252" not in src
        assert src.count("__global__") == len(plans[f].groups)
    assert '#include "fp252.cuh"' in plans["fp252"].source
    # air_plan with the field's constants gives the prover's plan
    assert codegen.air_plan(PlainAirConfig, n, 2, F=GL3).field == "gl3"
    assert codegen.air_plan(PlainAirConfig, n, 2).source == \
        codegen.air_plan(PlainAirConfig, n, 2, F=Fp252).source
    with pytest.raises(ValueError, match="no group kernels"):
        codegen.lower(cons, 2 * n, [], 8, "bn254")


def test_group_tables_take_the_fields_words():
    """check_group_tables for L = 2 and 6: rows of the field's words, 8-byte
    aligned with even row strides (a u64 coordinate a load), refused
    otherwise; 32-bit word offsets as for Fp252."""
    meta = torch.device("meta")

    def rows(n, L, stride):
        return torch.empty_strided((n, L), (stride, 1), dtype=torch.int32,
                                   device=meta)

    N = 1 << 21
    for L, cols in ((2, 5), (6, 6)):
        out = rows(N, L, L)
        codegen.check_group_tables(out, [rows(N, L, L * cols)], N, N, L)
        with pytest.raises(ValueError, match="8-byte"):
            codegen.check_group_tables(out, [rows(N, L, L * cols + 1)], N,
                                       N, L)
        with pytest.raises(ValueError, match="8-byte"):
            codegen.check_group_tables(out, [rows(N, 8, 8)], N, N, L)
        with pytest.raises(ValueError, match="32-bit"):
            codegen.check_group_tables(out, [rows(N, L, 1 << 12)], N, N, L)


# -- the scan and the batch inversion -----------------------------------------

@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("n", [1, 5, 64, 257])
def test_prefix_mul_matches_jax(name, n):
    """prefix_mul (gl_scan_mul's plain version on the CPU) of [n] and
    [n, 3] arrays, both directions, equals the JAX package's prefix_mul."""
    F, JF = FIELDS[name]
    rng = random.Random(n)
    for shape in ((n,), (n, 3)):
        vals = _ints(F, rng, int(np.prod(shape)))
        ja, ta = _both(F, JF, vals, shape)
        for reverse in (False, True):
            assert _agree(jax_prefix_mul(JF, ja, reverse=reverse),
                          prefix_mul(F, ta, reverse))
            assert torch.equal(
                prefix_scan(gl_cuda.plain_ops(F.NLIMBS)[2], ta, reverse),
                prefix_mul(F, ta, reverse))


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_batch_inv_many_matches_jax_with_zero_columns(name):
    """batch_inv_many (gl_batch_inv's plain version on the CPU) over arrays
    of mixed lengths and widths, a zero in one column of two of them:
    each equals the JAX package's GL.batch_inv / GL3.batch_inv, whose
    zero column is all zeros, and the other columns are the inverses."""
    F, JF = FIELDS[name]
    rng = random.Random(3)
    shapes = [(1,), (7, 2), (33,), (64, 3)]
    arrays = []
    for shape in shapes:
        vals = _ints(F, rng, int(np.prod(shape)))
        arrays.append(_both(F, JF, vals, shape))
    for k, pos in ((1, (3, 1)), (3, (0, 2))):
        ja, ta = arrays[k]
        ta[pos] = 0
        arrays[k] = (jnp.asarray(ta.numpy().view(np.uint32)), ta)
    got = batch_inv_many(F, [ta for _, ta in arrays])
    assert len(got) == len(arrays)
    for (ja, ta), g in zip(arrays, got):
        assert g.shape == ta.shape
        assert _agree(JF.batch_inv(ja), g)
    assert not got[1][:, 1].any() and got[1][:, 0].any(dim=-1).all()
    assert not got[3][:, 2].any()
    one = F.s(1)
    for v, w in zip(F.decode_ints(arrays[2][1]), F.decode_ints(got[2])):
        assert F.s(v) * F.s(w) % F.MODULUS == one


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_host_trip_inverts_in_the_field(name):
    """invert_totals, the plain batch inversion's inversion of the
    columns' totals (gl_batch_inv inverts on the card): each total's
    inverse in the field (GL3: not the integer inverse of the packed int
    modulo p^3), a zero kept zero, equal to the JAX package's inverse of
    each."""
    F, JF = FIELDS[name]
    rng = random.Random(9)
    vals = _ints(F, rng, 6) + [0, 1, P - 1]
    ja, ta = _both(F, JF, vals)
    got = gl_cuda.invert_totals(ta)
    assert _agree(JF.inv(ja), got)
    inv = F.decode_ints(got)
    assert inv[6] == 0
    for v, w in zip(vals[:6], inv[:6]):
        assert F.s(v) * F.s(w) % F.MODULUS == F.s(1)
    for L in (4, 8):
        with pytest.raises(ValueError, match="neither"):
            gl_cuda.invert_totals(torch.zeros((2, L), dtype=torch.int32))


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_inv_of_one_element_matches_jax(name):
    """Repair: F.inv of a single [L] element (the eager walk's inverse of a
    scalar subtree) equals the JAX package's; GL.inv raised on it (the
    decoded 0-d array has no ravel)."""
    F, JF = FIELDS[name]
    for v in (_ints(F, random.Random(4), 1)[0], 0, 1):
        ja, ta = _both(F, JF, [v])
        assert _agree(JF.inv(ja[0]), F.inv(ta[0]))


def test_status_words_match_the_kernels_layout():
    """status_words, the look-back state of csrc/scan.cu and gl_scan.cu: the
    counter's 8 words, a flag a tile rounded up to 8, an aggregate and an
    inclusive prefix of L words a tile."""
    from sandstorm_tpu_torch.fields.fp252_cuda import status_words
    assert status_words(1, 2) == 8 + 8 + 4
    assert status_words(9, 6) == 8 + 16 + 12 * 9
    assert status_words(16) == status_words(16, 8) == 8 + 16 + 16 * 16


# -- DEEP ---------------------------------------------------------------------

N_TRACE, BLOWUP = 1 << 8, 2


def _targs(case):
    n = N_TRACE
    if case == "negative":
        return [(0, 0), (1, -1), (2, -3), (0, 1), (1, -7), (2, 2),
                (0, -n + 1)]
    # offsets of a trace length and beyond, whose shifted reads wrap
    return [(0, n), (1, n + 5), (2, 2 * n - 1), (0, 3), (1, 0),
            (2, 3 * n + 2), (1, 4), (2, 4)]


@functools.lru_cache(maxsize=None)
def _deep_case(name, case):
    """(the port's arguments after dom, the JAX package's _deep_compose as
    words) for a case: base-field trace columns (a GF(p^3) prove's base
    columns), extension-field composition columns, OODS values, z and
    alpha."""
    F, JF = FIELDS[name]
    targs = _targs(case)
    rng = random.Random(len(targs) + len(name))
    n, N = N_TRACE, N_TRACE * BLOWUP
    ncols = 1 + max(c for c, _ in targs)
    cols = {c: [rng.randrange(P) for _ in range(N)] for c in range(ncols)}
    comp = [_ints(F, rng, N) for _ in range(2)]
    tvals, cvals = _ints(F, rng, len(targs)), _ints(F, rng, 2)
    z, alpha = _ints(F, rng, 2)
    g = F.root_of_unity_int(n)
    args = (targs, {c: F.encode_ints(v, CPU) for c, v in cols.items()},
            [F.encode_ints(v, CPU) for v in comp], tvals, cvals, z, g, n,
            alpha)
    jdom = jprover._DomainCache(JF, N, JF.GENERATOR)
    want = jprover._deep_compose(
        JF, jdom, targs, {c: JF.encode_ints(v) for c, v in cols.items()},
        [JF.encode_ints(v) for v in comp], tvals, cvals, z, g, n, alpha)
    return args, np.asarray(want)


def _dom(F):
    return prover._DomainCache(F, N_TRACE * BLOWUP, F.GENERATOR, CPU)


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("case", ["negative", "wrapping"])
def test_shifted_deep_matches_jax(name, case):
    """_deep_shifted (gl_deep_compose's plain version: the host's
    shifted-denominator terms, u and v from one batch_inv_many, gathered
    at shifted rows) and deep_compose's CPU route (_deep_compose) equal
    the JAX package's _deep_compose, in GL and in GF(p^3)."""
    F, _ = FIELDS[name]
    args, want = _deep_case(name, case)
    got = prover._deep_shifted(F, _dom(F), *args)
    assert got.shape == (N_TRACE * BLOWUP, F.NLIMBS)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    got = prover.deep_compose(F, _dom(F), *args)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_shifted_terms_take_extension_products():
    """Repair: over GF(p^3) the coefficients a_j = c_j g^-o, the constants
    C_k = sum a_j t_j and the points z, z^m are products in the field (the
    packed ints multiplied as integers are other numbers, which the
    parent's `c * scale % p` and `int(F.s(z)) % p` took)."""
    args, _ = _deep_case("gl3", "negative")
    targs, cols, comp, tv, cv, z, g, n, alpha = args
    points, (z0, zm) = prover._deep_shifted_terms(GL3, _dom(GL3), *args)
    zs = Fq3S.from_packed(z)
    assert (z0, zm) == (z, int(zs * zs))
    assert zm != pow(z % P, 2, P)
    # the points in transcript order: the trace offsets sorted, each with
    # its arguments in order, then the composition point
    a_s = Fq3S.from_packed(alpha)
    offsets = sorted({off for _, off in targs})
    want = [[(j, cols[c], tv[j]) for j, (c, o) in enumerate(targs)
             if o == off] for off in offsets]
    want.append([(len(targs) + l, comp[l], cv[l]) for l in range(2)])
    assert len(points) == len(want)
    for k, ((shift, tab, terms, C), grp) in enumerate(zip(points, want)):
        trace = k < len(offsets)
        assert (shift, tab) == (((offsets[k] % n) * BLOWUP, 0) if trace
                                else (0, 1))
        scale = pow(g, -(offsets[k] % n), P) if trace else 1
        want_C = Fq3S(0)
        for (lde, a), (j, col, t) in zip(terms, grp):
            want_a = (a_s ** j) * scale
            assert lde is col and a == int(want_a)
            want_C = want_C + want_a * Fq3S.from_packed(t)
        assert len(terms) == len(grp) and C == int(want_C)


# -- the dense opener ---------------------------------------------------------

@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_dense_opener_matches_jax(name):
    """open_dense_plain (every column at every point through the outer
    product of the two power tables; _power_tables on the port's scan),
    the plain version of the opener, equals the JAX package's
    _open_all_at_point with its powers_host tables, for each of three
    points (one base-field); the opener's wrapper refuses power tables
    that do not fit the columns."""
    from sandstorm_tpu.ntt import powers_host
    from sandstorm_tpu.stark.openings import _open_all_at_point
    F, JF = FIELDS[name]
    rng = random.Random(17)
    n, C = 64, 3
    vals = [_ints(F, rng, n) for _ in range(C)]
    pts = _ints(F, rng, 2) + [rng.randrange(P)]
    cols = torch.stack([F.encode_ints(v, CPU) for v in vals])
    lo, hi = openings._power_tables(F, pts, n, CPU)
    got = openings.open_dense_plain(F, cols, lo, hi)
    assert got.shape == (len(pts), C, F.NLIMBS)
    b = lo.shape[1]
    jcols = tuple(JF.encode_ints(v) for v in vals)
    for k, pt in enumerate(pts):
        jlo = powers_host(JF, pt % F.MODULUS, b)
        jhi = powers_host(JF, int(pow(JF.s(pt), b, F.MODULUS)), n // b)
        assert _agree(jlo, lo[k]) and _agree(jhi, hi[k])
        want = _open_all_at_point(JF, jcols, jnp.asarray(jhi),
                                  jnp.asarray(jlo))
        assert _agree(want, got[k])
    with pytest.raises(ValueError, match="power tables"):
        openings.open_pairs_gl(F, list(cols), lo[:, :3], hi, [0], [0])


# -- the scalar and coefficient paths -----------------------------------------

def test_scalar_values_take_the_extension_field():
    """Repair: codegen.scalar_values evaluates the scalar subtrees with the
    field's own operations (IntContext with s = F.s).  Over GF(p^3) a
    product, a power and an inverse of challenges equal Fq3S's (the JAX
    package's host scalar), where the integer arithmetic modulo p^3 that
    the parent took gives other numbers."""
    c0, c1 = E.Challenge(0), E.Challenge(1)
    t = E.Trace(0, 0)
    exprs = [t * (c0 * c1 + 3), t * (E.Constant(1) / c0),
             t * (c0.pow(5) - 7)]
    plan = codegen.lower(exprs, 16, [], 8, "gl3")
    rng = random.Random(21)
    ch = _ints(GL3, rng, 2)
    got = [int(v) for v in codegen.scalar_values(plan, GL3, ch, [])]
    a, b = JFq3S.from_packed(ch[0]), JFq3S.from_packed(ch[1])
    want = {int(a * b + 3), int(a.inv()), int(a ** 5 - 7)}
    assert want <= set(got)
    wrong = {(ch[0] * ch[1] + 3) % GL3.MODULUS,
             pow(ch[0], 5, GL3.MODULUS) - 7}
    assert not wrong & set(got)
    # over GL the field's values are the integers' mod p
    plan = codegen.lower(exprs, 16, [], 8, "goldilocks")
    ch = _ints(GL, rng, 2)
    got = [int(v) for v in codegen.scalar_values(plan, GL, ch, [])]
    assert (ch[0] * ch[1] + 3) % P in got and pow(ch[0], P - 2, P) in got


def test_fold_coefficients_enter_through_the_field():
    """Repair: the fold coefficients are encoded through F.s, so a negative
    int is the base-field value (GL3.s(-1) = p - 1 in coordinate 0), as
    the eager fold's F.encode_int takes it; the parent's `int(c) % p`
    made it p^3 - 1, another element.  The interpreter's fold with
    coefficients (1, -1, 5) equals the eager walk folded with the same
    encoded coefficients."""
    N = 16
    t0, t1 = E.Trace(0, 0), E.Trace(1, 1)
    exprs = [t0 * t1, t0 - t1, t1 * t1]
    rng = random.Random(12)
    cols = {i: GL3.encode_ints(_ints(GL3, rng, N), CPU) for i in range(2)}
    dom = prover._DomainCache(GL3, N, GL3.GENERATOR, CPU)
    ctx = E.LdeContext(GL3, cols, 1, dom.domain, dom.x_pow)
    coeffs = [1, -1, 5]
    got = E.evaluate_lde_folded(exprs, ctx, N, coeffs)
    acc = None
    for c, v in zip(coeffs, E.evaluate_lde(exprs, ctx, N)):
        t = GL3.mul(v, GL3.encode_int(c, CPU))
        acc = t if acc is None else GL3.add(acc, t)
    assert torch.equal(got, acc)
    assert GL3.decode_ints(GL3.encode_ints([GL3.s(-1)], CPU)) == [P - 1]


# -- the tiny proofs through the kernels' route -------------------------------

@pytest.mark.parametrize("name", ["goldilocks", "gl3", "goldilocks_cairo"])
def test_tiny_proofs_through_the_kernel_route(name, monkeypatch):
    """The tiny claims (16 steps, 4 queries, 4 PoW bits) proved on the CPU
    through the route a CUDA prove takes (kernel_route forced: the group
    programs' interpreter over the whole domain, DEEP in the kernels'
    shifted form, _deep_shifted) equal the JAX package's proofs
    (TINY_SHA256), the constraints in one window."""
    from sandstorm_tpu_torch.claims import loop_claim
    from sandstorm_tpu_torch.stark.ark import serialize_proof
    from sandstorm_tpu_torch.stark.options import ProofOptions
    F = GL3 if name == "gl3" else GL
    monkeypatch.setattr(prover, "kernel_route", lambda device: True)
    monkeypatch.setattr(prover, "deep_compose", prover._deep_shifted)
    claim, witness = loop_claim(16, CPU, field=F,
                                scheme="cairo" if "cairo" in name
                                else "generic")
    blob = serialize_proof(claim.prove(
        witness, ProofOptions(num_queries=4, proof_of_work_bits=4)))
    assert hashlib.sha256(blob).hexdigest() == TINY_SHA256[name]
    assert prover.LAST_CHUNKS == {"constraint evaluation": 1}
