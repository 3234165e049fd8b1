"""The grouped composition fold of the port (air/expr.py evaluate_lde_folded,
the programs of air/codegen.py run by their plain interpreter on CPU
tensors) against the JAX package's evaluate_lde_folded and
evaluate_lde_folded_chunked and its eager evaluate_lde, on the CPU; the
emitted CUDA source checked as text.

Inputs are made from seeds and handed to both packages through
sandstorm_tpu_torch.interop.  Tolerance 0: the arithmetic is exact.  The
generated kernels are held to the interpreter on the card by
chip_smoke.py, which also holds the starknet fold at its own shape
(N = 2^22) to the eager route.
"""

import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.air import expr as JE
from sandstorm_tpu.fields.fp252 import Fp252 as JF
from sandstorm_tpu.ntt import powers_host
from sandstorm_tpu_torch.air import codegen
from sandstorm_tpu_torch.air import expr as E
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.interop import from_jax_digits, to_jax_digits
from sandstorm_tpu_torch.stark.prover import _DomainCache

P = TF.MODULUS
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small tensor ops on the CPU: one intra-op thread a
    test worker keeps the workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ints(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % P
            for _ in range(count)]


def _jax_x_pow(N, coset):
    """The JAX tests' X-power tables (tests/test_expr_chunked.py)."""
    w = JF.root_of_unity_int(N)

    def x_pow(e, period=None):
        period = period or N
        tbl = powers_host(JF, pow(w, e, P), period)
        ce = JF.encode_int(pow(coset, e, P))
        return JF.mul(jnp.asarray(tbl), jnp.broadcast_to(ce, tbl.shape))
    return x_pow


def _dags(N, which):
    """The DAGs of tests/test_expr_chunked.py's grouped tests, in both
    packages' nodes; "negative" reads trace values at negative offsets."""
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
        else:
            tm, tw = M.Trace(1, -3), M.Trace(0, -N)
            exprs = [tm * t0 - M.Challenge(0),
                     (tw - tm.pow(2)) / (M.X - 5) + M.X.pow(N // 2),
                     -tm * M.Challenge(0) * M.Challenge(0) - M.Constant(5)
                     / M.Constant(7),
                     (tm + t1) / (M.X.pow(N // 8) - 1)]
        out.append(exprs)
    return out


@pytest.mark.parametrize("which,N,B", [("folded", 32, None),
                                       ("chunked", 64, 16),
                                       ("negative", 64, None),
                                       ("negative", 64, 16)])
def test_interpreter_matches_jax_grouped_fold(which, N, B):
    """evaluate_lde_folded's plain version (group_size 2, blowup 2) equals
    the JAX package's evaluate_lde_folded (B None) or
    evaluate_lde_folded_chunked (windows of B rows), on the DAGs of
    tests/test_expr_chunked.py and one with negative trace offsets."""
    blowup, coset = 2, TF.GENERATOR
    rng = random.Random(11 if B is None else 13)
    cols = [[rng.randrange(P) for _ in range(N)] for _ in range(2)]
    ch = [rng.randrange(P)]
    jexprs, texprs = _dags(N, which)
    coeffs = [rng.randrange(P) for _ in jexprs]
    x_pow = _jax_x_pow(N, coset)
    jctx = JE.LdeContext(JF, {i: JF.encode_ints(c) for i, c in
                              enumerate(cols)}, blowup,
                         lambda: x_pow(1, N), x_pow,
                         challenges=[JF.encode_int(c) for c in ch],
                         coset=coset)
    if B is None:
        want = JE.evaluate_lde_folded(jexprs, jctx, N, coeffs, group_size=2)
    else:
        want = JE.evaluate_lde_folded_chunked(jexprs, jctx, N, coeffs, B,
                                              group_size=2)
    dom = _DomainCache(TF, N, coset, CPU)
    tctx = E.LdeContext(TF, {i: TF.encode_ints(c, CPU) for i, c in
                             enumerate(cols)}, blowup, dom.domain,
                        dom.x_pow, challenges=[TF.encode_int(ch[0], CPU)])
    got = E.evaluate_lde_folded(texprs, tctx, N, coeffs, group_size=2,
                                chunk_size=B)
    assert np.array_equal(to_jax_digits(got), np.asarray(want))
    # the eager walk of the port, folded the same way
    eager = E.evaluate_lde(texprs, tctx, N)
    acc = None
    for c, v in zip(coeffs, eager):
        t = TF.mul(v, TF.encode_int(c, CPU))
        acc = t if acc is None else TF.add(acc, t)
    assert torch.equal(got, acc)


def _jax_eager_fold(jexprs, jctx, N, alpha):
    def fold(acc, v, i):
        c = JF.encode_int(pow(alpha, i, P))
        t = JF.mul(v, jnp.broadcast_to(c, v.shape))
        return t if acc is None else JF.add(acc, t)
    return JE.evaluate_lde(jexprs, jctx, domain_size=N, fold=fold)


@pytest.mark.parametrize("layout", ["plain", "recursive"])
def test_layout_fold_matches_jax_eager(layout):
    """The plain (n = 16, blowup 2) and recursive (n = 4096, blowup 1: the
    smallest it takes) DAGs over random columns, with their periodic
    columns, folded with alpha powers: the interpreter over the whole
    domain and in windows equals the JAX package's eager evaluate_lde with
    the same fold."""
    if layout == "plain":
        from sandstorm_tpu.layouts.plain.air import PlainAirConfig as JA
        from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig as TA
        n, blowup, ncols = 16, 2, 6
    else:
        from sandstorm_tpu.layouts.recursive.air import \
            RecursiveAirConfig as JA
        from sandstorm_tpu_torch.layouts.recursive.air import \
            RecursiveAirConfig as TA
        n, blowup, ncols = 4096, 1, 10
    from sandstorm_tpu.stark.prover import _DomainCache as JaxDom
    rng = np.random.default_rng(31)
    N, coset = n * blowup, TF.GENERATOR
    vals = {c: _ints(rng, N) for c in range(ncols)}
    g = TF.root_of_unity_int(n)
    tcons = TA.constraints(n, P, g)
    leaves = [nd.key for nd in E.walk(tcons)]
    ch = _ints(rng, 1 + max(k[1] for k in leaves if k[0] == "challenge"))
    hints = _ints(rng, 1 + max(k[1] for k in leaves if k[0] == "hint"))
    alpha = _ints(rng, 1)[0]
    tper = TA.periodic_columns(n) if hasattr(TA, "periodic_columns") else []
    dom = _DomainCache(TF, N, coset, CPU)
    tctx = E.LdeContext(TF, {c: TF.encode_ints(v, CPU)
                             for c, v in vals.items()}, blowup, dom.domain,
                        dom.x_pow,
                        challenges=[TF.encode_int(c, CPU) for c in ch],
                        hints=[TF.encode_int(h, CPU) for h in hints],
                        periodic=[pc.lde_fn(TF, dom) for pc in tper])
    coeffs = [pow(alpha, i, P) for i in range(len(tcons))]
    whole = E.evaluate_lde_folded(tcons, tctx, N, coeffs)
    windows = E.evaluate_lde_folded(tcons, tctx, N, coeffs,
                                    chunk_size=N // 4)
    assert torch.equal(whole, windows)
    jdom = JaxDom(JF, N, coset)
    jper = JA.periodic_columns(n) if hasattr(JA, "periodic_columns") else []
    jctx = JE.LdeContext(JF, {c: JF.encode_ints(v) for c, v in vals.items()},
                         blowup, jdom.domain, jdom.x_pow,
                         challenges=[JF.encode_int(c) for c in ch],
                         hints=[JF.encode_int(h) for h in hints],
                         periodic=[pc.lde_fn(JF, jdom) for pc in jper],
                         coset=coset)
    want = _jax_eager_fold(JA.constraints(n, P, g), jctx, N, alpha)
    assert np.array_equal(to_jax_digits(whole), np.asarray(want))


def test_starknet_fold_in_windows_matches_host_evaluation(monkeypatch):
    """The 195 starknet constraints over random columns at 2^15 rows,
    blowup 1, with the periodic columns, set up as
    tests/test_torch_starknet.py sets up its composition test: the
    interpreter in windows of 256 rows (the first two, two in the middle,
    the last two) equals evaluate_int at 6 points, those of the last
    windows with trace offsets wrapping around the domain's end.  Only
    those windows run (the plain interpreter takes minutes over the whole
    domain on one CPU thread); chip_smoke.py holds the whole-domain fold
    at N = 2^22 to the eager route on the card."""
    from sandstorm_tpu_torch.layouts.starknet.air import StarknetAirConfig
    rng = np.random.default_rng(25)
    n, blowup, coset = 1 << 15, 1, TF.GENERATOR
    N = n * blowup
    vals = {c: _ints(rng, N) for c in range(10)}
    lde = {c: TF.encode_ints(v, CPU) for c, v in vals.items()}
    ch, hints, alpha = _ints(rng, 6), _ints(rng, 17), _ints(rng, 1)[0]
    cons = StarknetAirConfig.constraints(n, P, TF.root_of_unity_int(n))
    periodic = StarknetAirConfig.periodic_columns(n)
    dom = _DomainCache(TF, N, coset, CPU)
    ctx = E.LdeContext(TF, lde, blowup, dom.domain, dom.x_pow,
                       challenges=[TF.encode_int(c, CPU) for c in ch],
                       hints=[TF.encode_int(h, CPU) for h in hints],
                       periodic=[pc.lde_fn(TF, dom) for pc in periodic])
    coeffs = [pow(alpha, i, P) for i in range(len(cons))]
    starts = (0, N // 2, N - 512)
    run = codegen.run_group

    def some_windows(F, plan, g, tables, scalars, blowup_, row0, nrows,
                     out, accumulate):
        if any(s <= row0 < s + 512 for s in starts):
            run(F, plan, g, tables, scalars, blowup_, row0, nrows, out,
                accumulate)
        else:
            out.zero_()

    monkeypatch.setattr(codegen, "run_group", some_windows)
    small = E.evaluate_lde_folded(cons, ctx, N, coeffs, chunk_size=256)
    comp = TF.decode_ints(small)
    w = TF.root_of_unity_int(N)
    targs = E.trace_arguments(cons)
    assert max(off for _, off in targs) * blowup > 300
    for i in (0, 5, N // 2 + 300, N // 2 + 511, N - 300, N - 1):
        x = coset * pow(w, i, P) % P
        tv = {(c, off): vals[c][(i + off * blowup) % N]
              for (c, off) in targs}
        cv = E.evaluate_int(cons, E.IntContext(
            P, x, tv, ch, hints, [pc.eval_int(x, P) for pc in periodic]))
        assert comp[i] == sum(v * c for v, c in zip(cv, coeffs)) % P


def test_codegen_source_is_a_function_of_the_dag_shape():
    """The CUDA source depends on the DAG's shape alone: the plain layout's
    DAG lowered at 2^16 and 2^20 rows (other constants, the same shape)
    gives the same text, twice; the recursive layout's another.  Every
    per-row non-leaf node of a group appears in its kernel once (as one
    instruction, a pow as its multiplies), and every constraint's fold
    once, in order."""
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.layouts.recursive.air import RecursiveAirConfig

    def plan(A, n, blowup=2):
        cons = A.constraints(n, P, TF.root_of_unity_int(n))
        pcs = A.periodic_columns(n) if hasattr(A, "periodic_columns") else []
        return cons, codegen.lower(cons, n * blowup,
                                   [n * blowup // pc.exponent for pc in pcs])

    cons, a = plan(PlainAirConfig, 1 << 16)
    _, b = plan(PlainAirConfig, 1 << 20)
    _, c = plan(PlainAirConfig, 1 << 16)
    assert a.source == b.source == c.source and a.stem == b.stem
    # the constants (the zerofiers' roots of unity) differ, in the buffer
    assert [x.key for x in a.scalars] != [x.key for x in b.scalars]
    rcons, r = plan(RecursiveAirConfig, 1 << 12)
    assert r.source != a.source and r.stem != a.stem
    rper = [r.N // pc.exponent
            for pc in RecursiveAirConfig.periodic_columns(1 << 12)]
    for cs, p, periods in ((cons, a, []), (rcons, r, rper)):
        nodes = E.walk(cs)
        number = {id(nd): i for i, nd in enumerate(nodes)}
        kind, _ = codegen._classify(nodes, p.N, periods)
        kernels = p.source.split("__global__")[1:]
        assert len(kernels) == len(p.groups) == -(-len(cs) // 8)
        for g, body in enumerate(kernels):
            grp = cs[8 * g:8 * g + 8]
            # the per-row nodes a root reaches through per-row nodes (the
            # inside of a hoisted zerofier is computed before the groups)
            rows, stack = set(), [nd for nd in grp if kind[id(nd)] == "row"]
            while stack:
                nd = stack.pop()
                if number[id(nd)] not in rows:
                    rows.add(number[id(nd)])
                    stack += [a for a in nd.args if kind[id(a)] == "row"]
            tags = [int(t) for t in re.findall(r"// n(\d+) \w+$", body,
                                               re.M)]
            pows = {i for i in rows if nodes[i].key[0] == "pow"}
            assert set(tags) == rows
            assert all(tags.count(t) == 1 for t in rows - pows)
            folds = [int(t) for t in re.findall(r"// fold (\d+)$", body,
                                                re.M)]
            assert folds == list(range(8 * g, 8 * g + len(grp)))
    # the product and the square out of line, each group its own
    # translation unit
    assert "__noinline__ fp::F M(" in a.source and "= M(" in a.source
    assert a.source == "\n".join(a.sources) and len(a.sources) == len(a.groups)


@pytest.mark.parametrize("layout", ["plain", "recursive", "starknet"])
def test_group_source_loads_each_operand_once_and_reduces_once(layout):
    """Each group's translation unit (the layout's plan at its path's
    size) computes each distinct row offset once, loads each distinct
    (table, offset) and periodic table once, at its first use, into a
    named value, calls the out-of-line montmul M for each product (Q for
    a square), and folds its constraints through one 512-bit accumulator
    and one reduction (16 folds or fewer a group)."""
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.layouts.recursive.air import RecursiveAirConfig
    from sandstorm_tpu_torch.layouts.starknet.air import StarknetAirConfig
    A, n = {"plain": (PlainAirConfig, 1 << 20),
            "recursive": (RecursiveAirConfig, 1 << 18),
            "starknet": (StarknetAirConfig, 1 << 21)}[layout]
    plan = codegen.air_plan(A, n, 2)
    assert len(plan.sources) == len(plan.groups)
    for g, (grp, src) in enumerate(zip(plan.groups, plan.sources)):
        assert src.count("__global__") == 1
        assert f'extern "C" int {codegen.ENTRY}{g}(' in src
        reads = {o for ins in grp.code for o in codegen._operands(ins)
                 if o[0] in ("t", "p")}
        loads = re.findall(r"const fp::F (\w+) = fp::load\(tabs\.p\[", src)
        assert sorted(loads) == sorted(codegen._arg(o) for o in reads)
        offs = {o[2] for o in reads if o[0] == "t"}
        idx = re.findall(r"const uint32_t (o\w+) = \(row \+ ", src)
        assert sorted(idx) == sorted(codegen._off_name(o) for o in offs)
        # every loaded value is defined before any line reads it
        body = src.splitlines()
        for name in loads:
            first = next(i for i, line in enumerate(body)
                         if re.search(rf"\b{name}\b", line))
            assert body[first].startswith(f"  const fp::F {name} = ")
        folds = [ins for ins in grp.code if ins[0] == "fold"]
        assert 1 <= len(folds) <= codegen.WIDE_TERMS
        assert src.count("fp::mul_wide(acc") == 1
        assert src.count("fp::mac_wide(acc") == len(folds) - 1
        assert src.count("fp::redc(") == 1
        muls = [ins for ins in grp.code if ins[0] == "mul"]
        assert src.count(" = Q(") == sum(1 for ins in muls
                                         if ins[2] == ins[3])
        assert src.count(" = M(") + src.count(" = Q(") == len(muls)
        assert "fp::mul_wide_redc(a, b)" in src
        assert "long long)" not in src.split("extern")[0]


def test_group_tables_refuse_32_bit_overflow():
    """check_group_tables (the group kernels' wrapper) refuses a table whose
    last word's offset overflows 32 bits, a domain that is no power of two
    or beyond 2^32 rows, and an output of more than 2^29 rows; it takes
    starknet's largest, 2^22 rows of a 10-column stack."""
    meta = torch.device("meta")

    def rows(n, stride):
        return torch.empty_strided((n, 8), (stride, 1), dtype=torch.int32,
                                   device=meta)

    out = rows(1 << 22, 8)
    codegen.check_group_tables(out, [rows(1 << 22, 80), rows(16, 8)],
                               1 << 22, 1 << 22)
    with pytest.raises(ValueError, match="32-bit"):
        codegen.check_group_tables(out, [rows(1 << 22, 1 << 11)], 1 << 22,
                                   1 << 22)
    with pytest.raises(ValueError, match="32-bit"):
        codegen.check_group_tables(rows(1 << 30, 8), [], 1 << 30, 1 << 30)
    with pytest.raises(ValueError, match="power of two"):
        codegen.check_group_tables(out, [], 3 << 20, 1 << 20)
    with pytest.raises(ValueError, match="power of two"):
        codegen.check_group_tables(out, [], 1 << 33, 1 << 20)
    with pytest.raises(ValueError, match="16-byte"):
        codegen.check_group_tables(out, [rows(1 << 22, 6)], 1 << 22,
                                   1 << 22)
