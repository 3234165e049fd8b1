"""The typed Goldilocks / GF(p^3) route on the CPU: the group programs
lowered with the base columns a prove names (air/codegen.py typed_code)
and the pair-indexed opener (stark/openings.py open_pairs_gl), against an
independent walk of the DAG and against the JAX package.

- the typed lowering's products and folds by their operands' fields, the
  plain layout's 123 / 18 / 6 and 33 / 14 over GF(p^3), against a walk of
  the DAG in this file; over Goldilocks every value base; the Fp252 plans
  unchanged (their stems pinned);
- the typed GF(p^3) source: each product's helper by its operands' fields
  (no GF(p^3) product on a base x base instruction), and a source and a
  stem other than the untyped plan's;
- a typed plan's groups (their plain interpreter, whole domain and in
  windows) on base-field main columns against the JAX package's eager
  evaluate_lde folded with the same coefficients, over GL and GF(p^3);
- the opener's pair groups, its argument checks, and its values at the
  plain layout's 50 pairs (its plain version over base-field leading
  columns) against the JAX package's _open_all_at_point at those pairs;
- the checks that a column named base holds base-field values.

Inputs are made from seeds and handed to both packages as the same u32
words.  Tolerance 0: the arithmetic is exact.  The kernels themselves run
only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import collections
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.air import expr as JE
from sandstorm_tpu.fields.gl3 import GL3 as JG3
from sandstorm_tpu.fields.goldilocks import GL as JGL
from sandstorm_tpu.stark import prover as jprover
from sandstorm_tpu_torch.air import codegen
from sandstorm_tpu_torch.air import expr as E
from sandstorm_tpu_torch.fields.fp252_cuda import OPEN_GROUP, pair_groups
from sandstorm_tpu_torch.fields.gl3 import GL3
from sandstorm_tpu_torch.fields.goldilocks import GL
from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
from sandstorm_tpu_torch.stark import openings, prover

CPU = torch.device("cpu")
P = GL.MODULUS
FIELDS = {"goldilocks": (GL, JGL), "gl3": (GL3, JG3)}
NB = PlainAirConfig.NUM_BASE_COLUMNS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ints(F, rng, count):
    return [rng.randrange(F.MODULUS) for _ in range(count)]


def _agree(jax_arr, port_t):
    return np.array_equal(np.asarray(jax_arr), port_t.numpy().view(np.uint32))


def _plain_cons(F, n):
    return PlainAirConfig.constraints(n, F.MODULUS, F.root_of_unity_int(n),
                                      base_modulus=P)


# -- the typed lowering -------------------------------------------------------

def _walk_counts(cons, N, base_cols, gl3, group_size=8):
    """The row products and folds of each group's roots by their operands'
    fields, from the DAG: a node holds an extension value over GF(p^3)
    when a challenge, a hint or a trace column outside base_cols lies
    under it; a group computes each per-row node under its roots once."""
    nodes = E.walk(cons)
    kind, _ = codegen._classify(nodes, N, [])
    memo = {}

    def is_ext(n):
        if id(n) not in memo:
            op = n.key[0]
            memo[id(n)] = gl3 and (
                op in ("challenge", "hint")
                or (op == "trace" and n.key[1] not in base_cols)
                or any(is_ext(a) for a in n.args))
        return memo[id(n)]

    counts = collections.Counter()
    for g0 in range(0, len(cons), group_size):
        seen = set()

        def visit(n):
            if kind[id(n)] != "row" or id(n) in seen:
                return
            seen.add(id(n))
            for a in n.args:
                visit(a)
            assert n.key[0] != "pow", "a per-row pow: no layout has one"
            if n.key[0] == "mul":
                counts[("base_base", "base_ext", "ext_ext")[
                    sum(is_ext(a) for a in n.args)]] += 1

        for r in cons[g0:g0 + group_size]:
            visit(r)
            counts["fold_ext" if is_ext(r) else "fold_base"] += 1
    return counts


@pytest.mark.parametrize("name,base,want", [
    ("gl3", range(NB), (123, 18, 6, 33, 14)),
    ("gl3", (), None),
    ("goldilocks", range(NB), (147, 0, 0, 47, 0)),
    ("goldilocks", (), (147, 0, 0, 47, 0)),
])
def test_typed_lowering_counts_products_by_field(name, base, want):
    """The plain layout's plan at n = 2^20 (as plain-gl3-2^16 and
    plain-cairo-gl-2^16 lower it): its products and folds by field equal
    the walk of the DAG, and with its 5 main columns named base, over
    GF(p^3) 123 base x base, 18 base x extension and 6 extension products
    and 33 folds of a base value and 14 of an extension one (396
    Goldilocks products a row against the 1746 of 194 GF(p^3) products);
    over Goldilocks every instruction is base whatever the caller
    names."""
    F = FIELDS[name][0]
    n = 1 << 20
    cons = _plain_cons(F, n)
    plan = codegen.air_plan(PlainAirConfig, n, 2, F=F, base_cols=base)
    got = codegen.product_counts(plan)
    walked = _walk_counts(cons, 2 * n, set(base), name == "gl3")
    assert got == {k: walked[k] for k in got}
    if want is not None:
        assert tuple(got.values()) == want
    if name == "gl3" and base:
        assert codegen.gl_products(plan) == 396
        assert plan.base_cols == frozenset(range(NB))
    if name == "goldilocks":
        assert codegen.gl_products(plan) == 194
        assert not plan.ext_tables and not plan.ext_scalars
        assert not plan.base_cols
        assert all(not any(fs) for g in range(len(plan.groups))
                   for _, fs in codegen.typed_code(plan, g))


def test_fp252_plans_unchanged():
    """The Fp252 plans ignore the base columns and keep their sources
    byte for byte: their stems are the ones the Fp252 kernels were built
    and measured under."""
    from sandstorm_tpu_torch.layouts.recursive.air import RecursiveAirConfig
    pinned = {(PlainAirConfig, 1 << 10): "air_12af687a83db2fc0",
              (RecursiveAirConfig, 1 << 18): "air_6de1e5c54f9c5d26"}
    for (A, n), stem in pinned.items():
        plan = codegen.air_plan(A, n, 2)
        assert plan.stem == stem
        assert codegen.air_plan(A, n, 2, base_cols=range(5)) is plan
        assert not plan.ext_tables and not plan.ext_scalars


def test_typed_gl3_source_takes_products_by_field():
    """The typed GF(p^3) source: every base x base product is one
    gl::mul, every base x extension one gl3::mul_base, every extension
    product gl3::mul, every fold of a base value gl3::mac_base and of an
    extension value gl3::mac; the base tables and scalars load one word.
    The source names its base columns and differs from the untyped plan's
    (so does its stem)."""
    n = 1 << 10
    typed = codegen.air_plan(PlainAirConfig, n, 2, F=GL3,
                             base_cols=range(NB))
    untyped = codegen.air_plan(PlainAirConfig, n, 2, F=GL3)
    assert typed.stem != untyped.stem and typed.source != untyped.source
    assert "// base trace columns: 0 1 2 3 4" in typed.source
    assert "// base trace columns: none" in untyped.source
    helper = {"base_base": "gl::mul(", "base_ext": "gl3::mul_base(",
              "ext_ext": "gl3::mul(", "fold_base": "gl3::mac_base(",
              "fold_ext": "gl3::mac("}
    for plan in (typed, untyped):
        want = codegen.product_counts(plan)
        for k, h in helper.items():
            assert plan.source.count(h) == want[k], k
        for g, src in enumerate(plan.sources):
            lines = src.splitlines()
            for ins, fs in codegen.typed_code(plan, g):
                if ins[0] != "mul":
                    continue
                (line,) = [ln for ln in lines
                           if ln.endswith(f"// n{ins[4]} mul")]
                kind = ("base_base", "base_ext", "ext_ext")[sum(fs)]
                assert helper[kind] in line, (line, fs)
                if kind == "base_base":
                    assert line.strip().startswith("u") and "gl3" not in line
        # a base table loads its c0 word, an extension table three
        for t in range(len(plan.tables)):
            decl = [ln for ln in plan.source.splitlines()
                    if f"tabs.p[{t}]" in ln and "load" in ln]
            ext = t in plan.ext_tables
            assert decl and all(("const E " in ln) == ext
                                and ("gl::load" in ln) != ext for ln in decl)
        assert "Fd::mul" not in plan.source


def _dags(M, N, which):
    t0, t1 = M.Trace(0, 0), M.Trace(1, 1)
    if which == "mixed":
        # base x base, base x extension, extension products, mixed adds
        # and subs both ways round, negations, constants over base values
        return [t0 * t0 - t0 * 3, (t0 - t1) * (t1 + t0) - M.Challenge(0),
                (M.Constant(5) - t0) * t1 * t1 + M.X * t0,
                -(t0 + M.Challenge(0)) * (M.X - t1),
                (t0.pow(2) - t0) / (M.X.pow(N // 4) - 1), t0 - t1]
    tm = M.Trace(0, -3)
    return [tm * t0 - M.Challenge(0) * t0,
            (M.Trace(0, -N) - tm * tm) / (M.X - 5) + M.X.pow(N // 2),
            -tm * M.Challenge(0) - M.Constant(5) / M.Constant(7),
            (tm + t1) / (M.X.pow(N // 8) - 1)]


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("which,N", [("mixed", 32), ("negative", 64)])
def test_typed_groups_match_jax_eager_fold(name, which, N):
    """A plan typed with column 0 named base (base-field values) and
    column 1 an extension column, run through its groups' plain
    interpreter (group size 2) over the whole domain and in windows,
    equals the JAX package's eager evaluate_lde folded with the same
    coefficients."""
    F, JF = FIELDS[name]
    rng = random.Random(N + len(name))
    coset, blowup = F.GENERATOR, 2
    cols = [[rng.randrange(P) for _ in range(N)], _ints(F, rng, N)]
    ch = _ints(F, rng, 1)
    alpha = F.s(_ints(F, rng, 1)[0])
    texprs, jexprs = _dags(E, N, which), _dags(JE, N, which)
    coeffs = [alpha ** (i + 1) for i in range(len(texprs))]
    jdom = jprover._DomainCache(JF, N, coset)
    jctx = JE.LdeContext(JF, {i: JF.encode_ints(c) for i, c in
                              enumerate(cols)}, blowup, jdom.domain,
                         jdom.x_pow,
                         challenges=[JF.encode_int(c) for c in ch],
                         coset=coset)

    def fold(acc, v, i):
        t = JF.mul(v, jnp.broadcast_to(JF.encode_int(int(coeffs[i])),
                                       v.shape))
        return t if acc is None else JF.add(acc, t)

    want = JE.evaluate_lde(jexprs, jctx, domain_size=N, fold=fold)
    dom = prover._DomainCache(F, N, coset, CPU)
    tctx = E.LdeContext(F, {i: F.encode_ints(c, CPU) for i, c in
                            enumerate(cols)}, blowup, dom.domain, dom.x_pow,
                        challenges=[F.encode_int(c, CPU) for c in ch])
    plan = codegen.lower(texprs, N, [], 2, F.NAME, [0])
    if name == "gl3":
        assert plan.base_cols == {0} and plan.ext_tables
    whole = E.evaluate_lde_folded(texprs, tctx, N, coeffs, group_size=2,
                                  base_cols=[0])
    windows = E.evaluate_lde_folded(texprs, tctx, N, coeffs, group_size=2,
                                    chunk_size=N // 4, base_cols=[0])
    assert _agree(want, whole)
    assert torch.equal(whole, windows)


def test_base_columns_must_hold_base_values():
    """Over GF(p^3) the typed kernels read a base column as its c0 word, so
    the prover checks its base trace once, before the interpolation: a
    trace whose base column has a nonzero upper coordinate is refused
    (gl_cuda.check_base_embedded), the trace builders' own columns pass,
    and over Goldilocks there is nothing to check."""
    from sandstorm_tpu_torch.claims import loop_claim
    from sandstorm_tpu_torch.fields.gl_cuda import check_base_embedded
    from sandstorm_tpu_torch.stark.options import ProofOptions
    claim, witness = loop_claim(16, CPU, field=GL3)
    trace = claim.generate_trace(witness)
    cols = trace.base_columns()
    check_base_embedded(cols.values(), "the base trace")
    bad = cols[NB - 1].clone()
    bad[3, 4] = 1
    cols[NB - 1] = bad
    with pytest.raises(ValueError, match="nonzero upper"):
        prover.prove(GL3, claim.air_config, trace,
                     ProofOptions(num_queries=4, proof_of_work_bits=4))
    with pytest.raises(ValueError, match="nonzero upper"):
        check_base_embedded([cols[0], bad[:, None]], "two columns")
    rng = random.Random(5)
    check_base_embedded([GL.encode_ints(_ints(GL, rng, 16), CPU)], "GL")


# -- the pair-indexed opener --------------------------------------------------

def _plain_pairs(F, n):
    """open_columns' pair list of the plain layout: the trace arguments
    (col, offset) on their sorted offsets, then the 2 composition columns
    (positions 6, 7) at one more point."""
    targs = E.trace_arguments(_plain_cons(F, n))
    offsets = sorted({off for _, off in targs})
    pairs = sorted({(offsets.index(off), c) for c, off in targs})
    return pairs + [(len(offsets), 6), (len(offsets), 7)], len(offsets) + 1


@pytest.mark.parametrize("pairs", [
    [(0, 0)],
    [(2, 5), (0, 1), (2, 0), (1, 1), (0, 5), (2, 5)],
    [(1, c) for c in range(11)] + [(0, 3)],
    "plain"])
def test_pair_groups_place_every_pair_once(pairs):
    """pair_groups' table (the opener's grid): every pair's position once,
    in a row of its point with its column, at most OPEN_GROUP columns a
    row; the plain layout's 50 pairs on 20 points."""
    if pairs == "plain":
        pairs, K = _plain_pairs(GL3, 1 << 10)
        assert (len(pairs), K) == (50, 20)
    kidx, cidx = [k for k, _ in pairs], [c for _, c in pairs]
    table = pair_groups(kidx, cidx)
    placed = []
    for row in table.tolist():
        k, m = row[0], row[1]
        assert 1 <= m <= OPEN_GROUP
        for c, p in zip(row[2:2 + m], row[2 + OPEN_GROUP:2 + OPEN_GROUP + m]):
            assert (kidx[p], cidx[p]) == (k, c)
            placed.append(p)
    assert sorted(placed) == list(range(len(pairs)))


def test_open_pairs_gl_refuses_what_the_kernel_does_not_take():
    """The opener's wrapper: base columns between 0 and C, power tables
    of the columns' length (b a power of two dividing n), columns of one
    shape, pairs within the points and columns."""
    rng = random.Random(3)
    n, C = 64, 3
    cols = [GL3.encode_ints(_ints(GL3, rng, n), CPU) for _ in range(C)]
    lo, hi = openings._power_tables(GL3, _ints(GL3, rng, 2), n, CPU)
    ok = openings.open_pairs_gl(GL3, cols, lo, hi, [0, 1], [2, 0], 0)
    assert ok.shape == (2, 6)
    for nbase in (-1, C + 1):
        with pytest.raises(ValueError, match="base columns"):
            openings.open_pairs_gl(GL3, cols, lo, hi, [0], [0], nbase)
    with pytest.raises(ValueError, match="power tables"):
        openings.open_pairs_gl(GL3, cols, lo[:, :3], hi, [0], [0])
    with pytest.raises(ValueError, match="power tables"):
        openings.open_pairs_gl(GL3, cols, lo, hi[:, 1:], [0], [0])
    with pytest.raises(ValueError, match="power tables"):
        openings.open_pairs_gl(GL3, cols[:2] + [cols[2][:32]], lo, hi, [0],
                               [0])
    with pytest.raises(ValueError, match="power tables"):
        openings.open_pairs_gl(GL3, [], lo, hi, [], [])
    for kidx, cidx in (([2], [0]), ([0], [3]), ([0, 1], [0])):
        with pytest.raises(ValueError, match="pair lists"):
            openings.open_pairs_gl(GL3, cols, lo, hi, kidx, cidx)


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_open_pairs_at_the_plain_pairs_match_jax(name):
    """The opener's plain version at the plain layout's 50 pairs on 20
    points over 8 columns (strided views of one [n, 8, L] tensor, the 5
    main columns base-field values and named base) equals the JAX
    package's _open_all_at_point at those pairs, with its powers_host
    tables; open_columns with the base columns named gives the values of
    open_columns with none named."""
    from sandstorm_tpu.ntt import powers_host
    from sandstorm_tpu.stark.openings import _open_all_at_point
    F, JF = FIELDS[name]
    rng = random.Random(23)
    n, C = 64, 8
    pairs, K = _plain_pairs(F, n)
    vals = [[rng.randrange(P) for _ in range(n)] if c < NB
            else _ints(F, rng, n) for c in range(C)]
    stack = torch.stack([F.encode_ints(v, CPU) for v in vals], 1)
    cols = list(stack.unbind(1))
    pts = _ints(F, rng, K)
    lo, hi = openings._power_tables(F, pts, n, CPU)
    kidx, cidx = [k for k, _ in pairs], [c for _, c in pairs]
    got = openings.open_pairs_gl(F, cols, lo, hi, kidx, cidx, NB)
    b = lo.shape[1]
    jcols = tuple(JF.encode_ints(v) for v in vals)
    dense = {}
    for k in sorted(set(kidx)):
        jlo = powers_host(JF, pts[k] % F.MODULUS, b)
        jhi = powers_host(JF, int(pow(JF.s(pts[k]), b, F.MODULUS)), n // b)
        dense[k] = np.asarray(_open_all_at_point(JF, jcols, jnp.asarray(jhi),
                                                 jnp.asarray(jlo)))
    for p, (k, c) in enumerate(pairs):
        assert np.array_equal(dense[k][c], got[p].numpy().view(np.uint32))
    targs = E.trace_arguments(_plain_cons(F, n))
    coeffs = {c: cols[c] for c in range(6)}
    coeffs.update({1000: cols[6], 1001: cols[7]})
    z, g = _ints(F, rng, 1)[0], F.root_of_unity_int(n)
    extra = dict(extra_points=[_ints(F, rng, 1)[0]],
                 extra_cols=[[1000, 1001]])
    assert openings.open_columns(F, coeffs, targs, z, g, n, **extra,
                                 base_cols=range(NB)) \
        == openings.open_columns(F, coeffs, targs, z, g, n, **extra)
