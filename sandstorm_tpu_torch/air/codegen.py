"""Constraint groups lowered to straight-line programs, rendered as one CUDA
kernel a group and run by a plain interpreter.

The port's counterpart of the JAX package's grouped composition fold
(sandstorm_tpu/air/expr.py:677 _group_eval_jit and :759
_group_eval_chunk_jit: one fused XLA dispatch a group of constraints).
lower() classifies every node of the DAG against the domain size N:

- scalar: made of constants, challenges and hints alone; evaluated on the
  host with python ints (evaluate_int) into the scalar buffer, beside the
  fold's coefficients, so that no claim value enters the source;
- trace: Trace(col, off), read at row (row + off * blowup) mod N;
- x / periodic: X^e and the periodic columns, tables of their period read
  at row mod period;
- hoist: a subtree free of trace values of period below N, or a zerofier
  inverse (an inv of X and constants alone, _domain_only_invs), evaluated
  once on its period before the groups run (expr._evaluate_periods,
  expr._hoisted_zinvs) and read as a table: the kernel inverts nothing;
- row: everything else, computed per row.

A group's program is a list of instructions over slots, reused once their
last reader has run: (op, dst, a, b, node) for op in add / sub / mul,
("neg", dst, a, node), and ("fold", a, coef, constraint) for acc +=
scalar[coef] * a.  An operand is ("r", slot), ("s", scalar row), ("t",
table, offset) or ("p", table).  A pow of a per-row value is expanded into
multiplies (square and multiply; no layout has one).  The CUDA source
depends on the DAG's shape and the field alone: node numbers are
positions in walk() order, tables and scalars are numbered by first use.
Fp252 renders through fp252.cuh (a slot is 8 words of a Montgomery form),
Goldilocks and GF(p^3) through goldilocks.cuh (a slot is one u64 or three
canonical coordinates); the field is part of the plan, so a DAG lowered
for two fields gives two sources and two libraries.

Over GF(p^3) every value also has a field of its own (typed_code): it is
base when every leaf under it is (constants, X and its powers, periodic
columns, the trace columns the caller names base, and the hoisted and
scalar subtrees built of those), an extension value otherwise
(challenges, hints, the other trace columns, the fold coefficients).  A
base value renders as one Goldilocks word, and a product as 1, 3 or the
extension product's Goldilocks products by its operands' fields; the
named columns are part of the plan and of its source.  Over Goldilocks
every value is base.
"""

import hashlib
import heapq
import math

import torch

from .. import _native
from ..fields.fp252_cuda import WIDE_TERMS
from .expr import IntContext, _domain_only_invs, evaluate_int, walk

THREADS = 128          # threads a block of a group kernel
# the fields a plan renders for (a field class's NAME), each with the
# launch counter of its group kernels (_native.LAUNCHES)
COUNTER = {"fp252": "air_group", "goldilocks": "air_group_gl",
           "gl3": "air_group_gl3"}
MIN_BLOCKS = 4         # blocks an SM holds: registers capped at 128
ENTRY = "air_g"        # group g's C entry is air_g<g>
# C entry: table pointers / masks / row strides (host int64 arrays),
# scalars, N, blowup, first row, rows, accumulate, out (+ stream)
_ARGTYPES = [_native._P, _native._P, _native._P, _native._P, _native._L,
             _native._L, _native._L, _native._L, _native._I, _native._P,
             _native._P]


class Group:
    """One group's program: its instructions and slot count."""

    __slots__ = ("code", "nslots")

    def __init__(self, code, nslots):
        self.code = code
        self.nslots = nslots


class Plan:
    """The lowered DAG: the `field` it renders for (a field class's NAME),
    `scalars` (the scalar subtrees, rows 0.. of the scalar buffer; the fold
    coefficients follow them), `tables` (("trace", col) | ("x", e, period)
    | ("periodic", i) | ("hoist", node number)), `hoisted` (node number ->
    node), `groups`, the GF(p^3) typing (`base_cols`, the trace columns
    named base; `ext_tables` and `ext_scalars`, the tables and scalar rows
    holding extension values, the fold coefficients' rows among them), and
    the CUDA `sources` (a translation unit a group; `source` is their text
    joined) with their library's `stem`."""

    def __init__(self, N, scalars, tables, hoisted, groups, field="fp252",
                 base_cols=frozenset(), ext_tables=frozenset(),
                 ext_scalars=frozenset()):
        if field not in COUNTER:
            raise ValueError(f"codegen: no group kernels for {field}")
        self.field = field
        self.N = N
        self.scalars = scalars
        self.tables = tables
        self.hoisted = hoisted
        self.groups = groups
        self.base_cols = base_cols
        self.ext_tables = ext_tables
        self.ext_scalars = ext_scalars
        # rows of the scalar buffer: the scalar subtrees, then a fold
        # coefficient a constraint
        self.scalar_rows = max((ins[2] + 1 for grp in groups
                                for ins in grp.code if ins[0] == "fold"),
                               default=len(scalars))
        self.sources = [render_group(self, g) for g in range(len(groups))]
        self.source = "\n".join(self.sources)
        self.stem = "air_" + hashlib.sha256(
            self.source.encode()).hexdigest()[:16]


def _classify(nodes, N, periodic_periods):
    """{id: kind} and {id: structural period} (0 = scalar) of every node."""
    zinv = {n.key for n in _domain_only_invs(nodes)}
    period, traced, kind = {}, {}, {}
    for n in nodes:
        op = n.key[0]
        if op in ("trace", "X"):
            p = N
        elif op in ("const", "challenge", "hint"):
            p = 0
        elif op == "periodic":
            p = periodic_periods[n.key[1]]
        elif op == "pow" and n.args[0].key[0] == "X":
            p = N // math.gcd(N, n.key[2])
        else:
            p = max(period[id(a)] for a in n.args)
        period[id(n)] = p
        traced[id(n)] = op == "trace" or any(traced[id(a)] for a in n.args)
        if p == 0:
            k = "scalar"
        elif op == "trace":
            k = "trace"
        elif op == "X" or (op == "pow" and n.args[0].key[0] == "X"):
            k = "x"
        elif op == "periodic":
            k = "periodic"
        elif (not traced[id(n)] and p < N) or (op == "inv" and n.key in zinv):
            k = "hoist"
        else:
            k = "row"
        kind[id(n)] = k
    return kind, period


_PLANS = {}


def lower(exprs, N: int, periodic_periods, group_size: int = 8,
          field: str = "fp252", base_cols=()) -> Plan:
    """Lower the constraints `exprs` (folded in this order) for a domain of
    N rows, the periodic columns of the given periods, `group_size`
    constraints a group, rendered for `field` (a field class's NAME), the
    trace columns `base_cols` holding base-field values (read so over
    GF(p^3); the other fields ignore them).  A prover lowers the same DAG
    in every prove: plans are kept for the process, keyed by the roots'
    identities (nodes are hash-consed and interned for the process, so an
    identity is never reused), the field and the base columns."""
    base = frozenset(base_cols) if field == "gl3" else frozenset()
    key = (tuple(map(id, exprs)), N, tuple(periodic_periods), group_size,
           field, base)
    if key not in _PLANS:
        _PLANS[key] = _lower(exprs, N, periodic_periods, group_size, field,
                             base)
    return _PLANS[key]


def _ext_nodes(nodes, base_cols):
    """The ids of the nodes holding GF(p^3) extension values: a challenge,
    a hint, a trace column not in base_cols, or any node above one."""
    ext = set()
    for n in nodes:
        op = n.key[0]
        if op in ("challenge", "hint") \
                or (op == "trace" and n.key[1] not in base_cols) \
                or any(id(a) in ext for a in n.args):
            ext.add(id(n))
    return ext


def _lower(exprs, N, periodic_periods, group_size, field, base_cols):
    nodes = walk(exprs)
    number = {id(n): i for i, n in enumerate(nodes)}
    kind, period = _classify(nodes, N, periodic_periods)
    ext = _ext_nodes(nodes, base_cols) if field == "gl3" else set()
    scalars, scalar_row = [], {}
    tables, table_of, hoisted = [], {}, {}

    def table(key):
        if key not in table_of:
            table_of[key] = len(tables)
            tables.append(key)
        return table_of[key]

    def leaf(n):
        """The operand of a node that is not computed per row."""
        k, key = kind[id(n)], n.key
        if k == "scalar":
            if id(n) not in scalar_row:
                scalar_row[id(n)] = len(scalars)
                scalars.append(n)
            return ("s", scalar_row[id(n)])
        if k == "trace":
            return ("t", table(("trace", key[1])), key[2])
        if k == "x":
            e = 1 if key[0] == "X" else key[2]
            return ("p", table(("x", e, period[id(n)])))
        if k == "periodic":
            return ("p", table(("periodic", key[1])))
        hoisted[number[id(n)]] = n
        return ("p", table(("hoist", number[id(n)])))

    groups = []
    for g0 in range(0, len(exprs), group_size):
        groups.append(_lower_group(exprs[g0:g0 + group_size], g0, kind,
                                   number, leaf))
    # the fold coefficients follow the scalar subtrees in the buffer
    for grp in groups:
        grp.code = [("fold", ins[1], len(scalars) + ins[2], ins[3])
                    if ins[0] == "fold" else ins for ins in grp.code]
    ext_scalars = {r for r, n in enumerate(scalars) if id(n) in ext}
    if field == "gl3":
        ext_scalars |= set(range(len(scalars), len(scalars) + len(exprs)))
    ext_tables = {t for t, key in enumerate(tables)
                  if (key[0] == "trace" and field == "gl3"
                      and key[1] not in base_cols)
                  or (key[0] == "hoist" and id(hoisted[key[1]]) in ext)}
    return Plan(N, scalars, tables, hoisted, groups, field, base_cols,
                frozenset(ext_tables), frozenset(ext_scalars))


def _lower_group(roots, first, kind, number, leaf) -> Group:
    """The program of one group: its per-row nodes in post order, each
    computed once, the roots folded in order (coefficient rows relative to
    the coefficients' start; lower() rebases them)."""
    uses, seen = {}, set()

    def count(n):
        for a in n.args:
            if kind[id(a)] == "row":
                uses[id(a)] = uses.get(id(a), 0) + 1
                if id(a) not in seen:
                    seen.add(id(a))
                    count(a)

    for r in roots:
        if kind[id(r)] == "row":
            uses[id(r)] = uses.get(id(r), 0) + 1
            if id(r) not in seen:
                seen.add(id(r))
                count(r)

    code, free, slot_of = [], [], {}
    nslots = [0]

    def alloc():
        if free:
            return heapq.heappop(free)
        nslots[0] += 1
        return nslots[0] - 1

    def operand(n):
        return ("r", slot_of[id(n)]) if kind[id(n)] == "row" else leaf(n)

    def release(n):
        if kind[id(n)] == "row":
            uses[id(n)] -= 1
            if uses[id(n)] == 0:
                heapq.heappush(free, slot_of.pop(id(n)))

    def ev(n):
        if kind[id(n)] != "row" or id(n) in slot_of:
            return
        for a in n.args:
            ev(a)
        op, tag = n.key[0], number[id(n)]
        ops = [operand(a) for a in n.args]
        if op == "pow":
            slot_of[id(n)] = _expand_pow(code, ops[0], n.key[2], tag, alloc,
                                         free)
            release(n.args[0])
            return
        if op == "inv":
            raise ValueError(
                f"codegen: node {tag} inverts a per-row value; only "
                f"zerofier inverses (X and constants) and scalars invert")
        for a in n.args:
            release(a)
        dst = alloc()
        if op in ("add", "sub", "mul"):
            code.append((op, dst, ops[0], ops[1], tag))
        elif op == "neg":
            code.append(("neg", dst, ops[0], tag))
        else:  # pragma: no cover
            raise ValueError(f"codegen: unknown node {op}")
        slot_of[id(n)] = dst

    for i, r in enumerate(roots):
        ev(r)
        code.append(("fold", operand(r), first + i, first + i))
        release(r)
    return Group(code, nslots[0])


def _expand_pow(code, base, e, tag, alloc, free):
    """base^e (e >= 2) as multiplies into fresh slots; returns the result's
    slot.  The base operand stays untouched (the caller releases it)."""
    if e < 2:
        raise ValueError(f"codegen: node {tag} raises a per-row value to "
                         f"the power {e}")
    temps = set()
    res, b = None, base
    while e:
        if e & 1:
            if res is None:
                res = b
            else:
                d = alloc()
                code.append(("mul", d, res, b, tag))
                old, res = res, ("r", d)
                temps.add(d)
                if old[0] == "r" and old[1] in temps and old != b:
                    temps.discard(old[1])
                    heapq.heappush(free, old[1])
        e >>= 1
        if e:
            d = alloc()
            code.append(("mul", d, b, b, tag))
            old, b = b, ("r", d)
            temps.add(d)
            if old[0] == "r" and old[1] in temps and old != res:
                temps.discard(old[1])
                heapq.heappush(free, old[1])
    if b != res and b[0] == "r" and b[1] in temps:
        heapq.heappush(free, b[1])
    return res[1]


def air_plan(air, n: int, blowup: int, group_size: int = 8, F=None,
             base_cols=()) -> Plan:
    """The plan a prove of the layout `air` at trace length n and LDE
    blowup lowers in the field class F (Fp252 when None; its periodic
    columns have period N / exponent on the LDE domain), with the trace
    columns `base_cols` named base (a prove names
    range(air.NUM_BASE_COLUMNS)): what a caller builds ahead of the
    prove."""
    if F is None:
        from ..fields.fp252 import Fp252 as F
    cons = air.constraints(n, F.MODULUS, F.root_of_unity_int(n),
                           base_modulus=F.BASE_MODULUS)
    pcs = air.periodic_columns(n) if hasattr(air, "periodic_columns") else []
    N = n * blowup
    return lower(cons, N, [N // pc.exponent for pc in pcs], group_size,
                 F.NAME, base_cols)


def typed_code(plan, g):
    """Group g's instructions with the fields of their operands (in
    _operands' order): [(instruction, (is extension, ...))].  A slot holds
    the field of the value last written to it; a result is an extension
    value when an operand is.  A fold's coefficient is an extension value
    over GF(p^3)."""
    slot_ext, out = {}, []
    for ins in plan.groups[g].code:
        fs = tuple(slot_ext[o[1]] if o[0] == "r" else
                   o[1] in plan.ext_scalars if o[0] == "s" else
                   o[1] in plan.ext_tables for o in _operands(ins))
        if ins[0] != "fold":
            slot_ext[ins[1]] = any(fs)
        out.append((ins, fs))
    return out


def product_counts(plan) -> dict:
    """The row products of the plan's groups by their operands' fields:
    base x base, base x extension, extension x extension, and the folds of
    a base and of an extension value."""
    c = dict.fromkeys(("base_base", "base_ext", "ext_ext", "fold_base",
                       "fold_ext"), 0)
    for g in range(len(plan.groups)):
        for ins, fs in typed_code(plan, g):
            if ins[0] == "mul":
                c[("base_base", "base_ext", "ext_ext")[sum(fs)]] += 1
            elif ins[0] == "fold":
                c["fold_ext" if fs[0] else "fold_base"] += 1
    return c


def gl_products(plan) -> int:
    """The Goldilocks products a row of the plan's group kernels needs: a
    product 1 over Goldilocks; over GF(p^3) 1 a base x base product, 3 a
    base x extension one and a fold of a base value (by its extension
    coefficient), 6 an extension product (Karatsuba's count)."""
    c = product_counts(plan)
    if plan.field != "gl3":
        return sum(c.values())
    return (c["base_base"] + 3 * (c["base_ext"] + c["fold_base"])
            + 6 * (c["ext_ext"] + c["fold_ext"]))


def build(plans) -> dict:
    """Build the plans' libraries that are missing, one nvcc a group, all
    at once: {stem: _native.build_generated's record}."""
    return _native.build_generated({pl.stem: pl.sources for pl in plans})


def scalar_values(plan, F, challenges, hints):
    """The scalar subtrees' values in the field class F for these
    challenges and hints (python ints; packed GF(p^3) ints, or Fq3S
    scalars, over GL3): every leaf enters through F.s, so that the host
    evaluation takes the field's own add, multiply and inverse (a packed
    GF(p^3) int is not the element)."""
    return evaluate_int(plan.scalars, IntContext(F.MODULUS, None, {},
                                                 challenges, hints, s=F.s))


# -- rendering ----------------------------------------------------------------

def _off_name(off):
    return f"o{off}" if off >= 0 else f"om{-off}"


def _arg(o):
    if o[0] == "r":
        return f"r{o[1]}"
    if o[0] == "s":
        return f"LS({o[1]})"
    if o[0] == "t":
        return f"t{o[1]}_{_off_name(o[2])}"
    return f"p{o[1]}"


def _operands(ins):
    """The operands an instruction reads, in order."""
    if ins[0] == "fold":
        return [ins[1]]
    if ins[0] == "neg":
        return [ins[2]]
    return [ins[2], ins[3]]


def render_group(plan, g) -> str:
    """The CUDA source of group g of a plan: one translation unit, its
    kernel g<g> and its C entry air_g<g>.

    The kernel takes a row a thread.  Row indices are 32-bit: each
    distinct row offset of the group is computed once, ((row + off *
    blowup) & (N - 1)), and each distinct (table, offset) loaded once, at
    its first use, into a named value.  A product is a call of M (a
    square of Q), fp252.cuh's montmul out of line (mul_wide_redc: its
    product of aligned pairs): inline, a group's products made kernels of
    many thousand instructions at up to 198 registers, which ran slower
    on the H100.  The folds add their 512-bit products (mac_wide, inline)
    and reduce once each WIDE_TERMS, then one modular add into out.
    Registers are capped for MIN_BLOCKS blocks an SM (faster on the H100
    than uncapped, though a few groups spill to a small stack frame).
    Goldilocks and GF(p^3) plans render through _render_gl."""
    if plan.field != "fp252":
        return _render_gl(plan, g)
    grp = plan.groups[g]
    nt = max(len(plan.tables), 1)
    folds = [ins for ins in grp.code if ins[0] == "fold"]
    nmul = sum(1 for ins in grp.code if ins[0] == "mul")
    out = [
        "// Generated by sandstorm_tpu_torch/air/codegen.py: constraint "
        f"group {g} of {len(plan.groups)}",
        f"// of one AIR ({len(folds)} folds, {nmul} products, {nt} tables).",
        "#include <cuda_runtime.h>",
        "",
        '#include "fp252.cuh"',
        "",
        "namespace {",
        "",
        f"constexpr int NT = {nt};",
        "struct Tabs {",
        "  const uint32_t* p[NT];",
        "  uint32_t m[NT];",
        "  uint32_t st[NT];",
        "};",
        "",
        "// the product and the square out of line: a group's 10 to 45 of",
        "// them inline make a kernel of many thousand instructions, which",
        "// ran slower on the H100",
        "__device__ __noinline__ fp::F M(const fp::F a, const fp::F b) {",
        "  return fp::mul_wide_redc(a, b);",
        "}",
        "",
        "__device__ __noinline__ fp::F Q(const fp::F a) {",
        "  return fp::sqr(a);",
        "}",
        "",
        "#define LS(s) fp::load(S + (s) * 8)",
        "",
        f"__global__ void __launch_bounds__({THREADS}, {MIN_BLOCKS})",
        f"g{g}(const __grid_constant__ Tabs tabs, "
        "const uint32_t* __restrict__ S, uint32_t nmask,",
        "    uint32_t blowup, uint32_t row0, uint32_t nrows, "
        "int accumulate,",
        "    uint32_t* __restrict__ out) {",
        f"  const uint32_t i = blockIdx.x * {THREADS} + threadIdx.x;",
        "  if (i >= nrows) return;",
        "  const uint32_t row = row0 + i;",
    ]
    if grp.nslots:
        out.append("  fp::F " + ", ".join(
            f"r{k}" for k in range(grp.nslots)) + ";")
    out.append("  uint32_t acc[16];")
    offsets, loaded = set(), set()
    pending, reduced = 0, False
    for ins in grp.code:
        for o in _operands(ins):
            if o[0] == "t" and o[2] not in offsets:
                offsets.add(o[2])
                out.append(f"  const uint32_t {_off_name(o[2])} = (row + "
                           f"(uint32_t)({o[2]}) * blowup) & nmask;")
            if o[0] in ("t", "p") and o not in loaded:
                loaded.add(o)
                t = o[1]
                idx = _off_name(o[2]) if o[0] == "t" else f"(row & tabs.m[{t}])"
                out.append(f"  const fp::F {_arg(o)} = fp::load(tabs.p[{t}] "
                           f"+ {idx} * tabs.st[{t}]);")
        op = ins[0]
        if op == "fold":
            fn = "mac_wide" if pending else "mul_wide"
            out.append(f"  fp::{fn}(acc, LS({ins[2]}), {_arg(ins[1])});  "
                       f"// fold {ins[3]}")
            pending += 1
            if pending == WIDE_TERMS:
                out.append("  res = fp::add(res, fp::redc(acc));" if reduced
                           else "  fp::F res = fp::redc(acc);")
                reduced, pending = True, 0
        elif op == "neg":
            out.append(f"  r{ins[1]} = fp::sub(fp::zero(), "
                       f"{_arg(ins[2])});  // n{ins[3]} neg")
        elif op == "mul" and ins[2] == ins[3]:
            out.append(f"  r{ins[1]} = Q({_arg(ins[2])});  "
                       f"// n{ins[4]} {op}")
        else:
            fn = "M" if op == "mul" else f"fp::{op}"
            out.append(f"  r{ins[1]} = {fn}({_arg(ins[2])}, "
                       f"{_arg(ins[3])});  // n{ins[4]} {op}")
    if pending:
        out.append("  res = fp::add(res, fp::redc(acc));" if reduced
                   else "  fp::F res = fp::redc(acc);")
    out += [
        "  if (accumulate) res = fp::add(fp::load(out + i * 8), res);",
        "  fp::store(out + i * 8, res);",
        "}",
        "",
        "}  // namespace",
        "",
    ]
    return "\n".join(out) + "\n" + render_group_entry(g)


def render_group_entry(g) -> str:
    """The C entry air_g<g> of a group's translation unit (every field's):
    the tables from host arrays into the kernel's grid constant, one
    launch of g<g> over the rows."""
    return "\n".join([
        f'extern "C" int {ENTRY}{g}(const long long* ptrs, '
        "const long long* masks,",
        "    const long long* strides, const void* S, long long N, "
        "long long blowup,",
        "    long long row0, long long nrows, int accumulate, void* out, "
        "void* stream) {",
        "  Tabs tabs;",
        "  for (int t = 0; t < NT; t++) {",
        "    tabs.p[t] = (const uint32_t*)ptrs[t];",
        "    tabs.m[t] = (uint32_t)masks[t];",
        "    tabs.st[t] = (uint32_t)strides[t];",
        "  }",
        "  if (nrows > 0)",
        f"    g{g}<<<(unsigned)((nrows + {THREADS - 1}) / {THREADS}), "
        f"{THREADS}, 0,",
        "            (cudaStream_t)stream>>>(tabs, (const uint32_t*)S, "
        "(uint32_t)(N - 1),",
        "                                    (uint32_t)blowup, "
        "(uint32_t)row0, (uint32_t)nrows,",
        "                                    accumulate, (uint32_t*)out);",
        "  return (int)cudaGetLastError();",
        "}",
        "",
    ])


def _gl_expr(op, A, B, fa, fb):
    """The expression of a Goldilocks / GF(p^3) add, sub or mul of operands
    A and B of the fields fa, fb (True: an extension value)."""
    if fa == fb:
        return f"{'gl3' if fa else 'gl'}::{op}({A}, {B})"
    e, b_ = (A, B) if fa else (B, A)      # the extension and the base value
    if op == "mul":
        return f"gl3::mul_base({e}, {b_})"
    if op == "add":
        return f"gl3::add_base({e}, {b_})"
    return f"gl3::sub_base({A}, {B})" if fa else f"gl3::base_sub({A}, {B})"


def _render_gl(plan, g) -> str:
    """render_group's source for a Goldilocks or GF(p^3) plan: the same
    program and row indexing over goldilocks.cuh, typed (typed_code): a
    base value is one u64 (`u<slot>`, a base table or scalar loaded as its
    c0 word), an extension value three coordinates (`r<slot>`), and each
    operation takes its operands' fields (a base x extension product is
    three Goldilocks products, an extension product gl3::mul, inline; an
    add or sub of mixed fields meets c0 alone).  Every such result is
    canonical and equals the GF(p^3) operation on the base values
    embedded, so the words are those of the untyped program.  The folds
    sum their products unreduced (gl::Wide a coordinate: a base value's
    fold 3 products, an extension value's 9) with the previous groups'
    sum when accumulating, and reduce once a coordinate at the end."""
    grp = plan.groups[g]
    nt = max(len(plan.tables), 1)
    gl3 = plan.field == "gl3"
    typed = typed_code(plan, g)
    muls = [fs for ins, fs in typed if ins[0] == "mul"]
    folds = [fs for ins, fs in typed if ins[0] == "fold"]
    ub = sorted({ins[1] for ins, fs in typed
                 if ins[0] != "fold" and not any(fs)})
    ue = sorted({ins[1] for ins, fs in typed if ins[0] != "fold" and any(fs)})

    def arg(o, ext):
        if o[0] == "r":
            return f"{'r' if ext else 'u'}{o[1]}"
        if o[0] == "s":
            return f"{'LS' if ext else 'LB'}({o[1]})"
        return _arg(o)

    out = [
        "// Generated by sandstorm_tpu_torch/air/codegen.py: constraint "
        f"group {g} of {len(plan.groups)}",
        f"// of one AIR over {plan.field} ({len(folds)} folds, {len(muls)} "
        f"products: {sum(1 for fs in muls if not any(fs))} base x base, "
        f"{sum(1 for fs in muls if sum(fs) == 1)} base x extension, "
        f"{sum(1 for fs in muls if all(fs))} extension x extension; "
        f"{nt} tables).",
    ]
    if gl3:
        out.append("// base trace columns: " + (" ".join(
            map(str, sorted(plan.base_cols))) or "none"))
    out += [
        "#include <cuda_runtime.h>",
        "",
        '#include "goldilocks.cuh"',
        "",
        "namespace {",
        "",
        f"using Fd = {'GL3F' if gl3 else 'GLF'};",
        "using E = gl3::E;",
        "constexpr int W = Fd::W;   // words an element of S and out",
        f"constexpr int NT = {nt};",
        "struct Tabs {",
        "  const uint32_t* p[NT];",
        "  uint32_t m[NT];",
        "  uint32_t st[NT];",
        "};",
        "",
        "#define LB(s) gl::load(S + (s) * W)",
        "#define LS(s) Fd::load(S + (s) * W)",
        "",
        f"__global__ void __launch_bounds__({THREADS}, {MIN_BLOCKS})",
        f"g{g}(const __grid_constant__ Tabs tabs, "
        "const uint32_t* __restrict__ S, uint32_t nmask,",
        "    uint32_t blowup, uint32_t row0, uint32_t nrows, "
        "int accumulate,",
        "    uint32_t* __restrict__ out) {",
        f"  const uint32_t i = blockIdx.x * {THREADS} + threadIdx.x;",
        "  if (i >= nrows) return;",
        "  const uint32_t row = row0 + i;",
    ]
    if ub:
        out.append("  uint64_t " + ", ".join(f"u{k}" for k in ub) + ";")
    if ue:
        out.append("  E " + ", ".join(f"r{k}" for k in ue) + ";")
    out.append("  Fd::A acc = Fd::a_zero();")
    offsets, loaded = set(), set()
    for ins, fs in typed:
        for o, ext in zip(_operands(ins), fs):
            if o[0] == "t" and o[2] not in offsets:
                offsets.add(o[2])
                out.append(f"  const uint32_t {_off_name(o[2])} = (row + "
                           f"(uint32_t)({o[2]}) * blowup) & nmask;")
            if o[0] in ("t", "p") and o not in loaded:
                loaded.add(o)
                t = o[1]
                idx = (_off_name(o[2]) if o[0] == "t"
                       else f"(row & tabs.m[{t}])")
                ty, ns = ("E", "gl3") if ext else ("uint64_t", "gl")
                out.append(f"  const {ty} {_arg(o)} = {ns}::load(tabs.p[{t}]"
                           f" + {idx} * tabs.st[{t}]);")
        op = ins[0]
        if op == "fold":
            a = arg(ins[1], fs[0])
            if not gl3:
                term = f"gl::mac(acc, LB({ins[2]}), {a})"
            elif fs[0]:
                term = f"gl3::mac(acc, {a}, gl3::dbl(LS({ins[2]})))"
            else:
                term = f"gl3::mac_base(acc, LS({ins[2]}), {a})"
            out.append(f"  {term};  // fold {ins[3]}")
            continue
        dst = f"{'r' if any(fs) else 'u'}{ins[1]}"
        if op == "neg":
            out.append(f"  {dst} = {'gl3' if fs[0] else 'gl'}::neg("
                       f"{arg(ins[2], fs[0])});  // n{ins[3]} neg")
        else:
            out.append(f"  {dst} = " + _gl_expr(
                op, arg(ins[2], fs[0]), arg(ins[3], fs[1]), *fs)
                + f";  // n{ins[4]} {op}")
    out += [
        "  if (accumulate) Fd::acc(acc, Fd::load(out + i * W));",
        "  Fd::store(out + i * W, Fd::reduce(acc));",
        "}",
        "",
        "}  // namespace",
        "",
    ]
    return "\n".join(out) + "\n" + render_group_entry(g)


# -- running a group ----------------------------------------------------------

def run_group_plain(F, plan, g, tables, scalars, blowup, row0, nrows, out,
                    accumulate):
    """The plain version of a group's kernel: its program over the field's
    ops on CPU tensors, rows row0 .. row0 + nrows into out [nrows, L]."""
    N = plan.N
    rows = torch.arange(row0, row0 + nrows, device=out.device)
    slots = [None] * plan.groups[g].nslots

    def val(o):
        if o[0] == "r":
            return slots[o[1]]
        if o[0] == "s":
            return scalars[o[1]]
        tbl = tables[o[1]]
        if o[0] == "t":
            return tbl[(rows + o[2] * blowup) & (N - 1)]
        return tbl[rows & (tbl.shape[0] - 1)]

    acc = None
    for ins in plan.groups[g].code:
        op = ins[0]
        if op == "fold":
            term = F.mul(val(ins[1]), scalars[ins[2]])
            acc = term if acc is None else F.add(acc, term)
        elif op == "neg":
            slots[ins[1]] = F.neg(val(ins[2]))
        else:
            slots[ins[1]] = getattr(F, op)(val(ins[2]), val(ins[3]))
    acc = acc.expand(out.shape)
    out.copy_(F.add(out, acc) if accumulate else acc)


def check_group_tables(out, tables, N, nrows, L: int = 8):
    """Raise unless a group kernel of a field of L-word elements takes
    these tables and output: rows of L int32 words on the output's device,
    aligned for the kernel's loads (Fp252: 16-byte words of rows 4 words
    apart; Goldilocks and GF(p^3): u64 coordinates, 8 bytes, rows 2 words
    apart), and every word offset it forms within 32 bits (N a power of
    two, each table's last row, each output row)."""
    align = _native.FIELD_KERNELS[L]["align"]
    if N & (N - 1) or N > 1 << 32:
        raise ValueError(f"air_group: {N} rows is not a power of two "
                         f"within 2^32")
    if nrows * L > 1 << 32:
        raise ValueError(f"air_group: {nrows} output rows overflow 32-bit "
                         f"word offsets")
    for t in tables:
        if t.device != out.device or t.dtype != torch.int32 \
                or t.shape[-1] != L or t.stride(1) != 1 \
                or t.stride(0) % (align // 4) or t.data_ptr() % align:
            raise ValueError(f"air_group: a table is not rows of {L} int32 "
                             f"words, {align}-byte aligned, on the output's "
                             f"device")
        if (t.shape[0] - 1) * t.stride(0) + L > 1 << 32:
            raise ValueError(f"air_group: a table of {t.shape[0]} rows at "
                             f"row stride {t.stride(0)} overflows 32-bit "
                             f"word offsets")


def run_group(F, plan, g, tables, scalars, blowup, row0, nrows, out,
              accumulate):
    """Group g of the plan over rows row0 .. row0 + nrows, written (or with
    `accumulate` added) into out [nrows, L]: the plain version for CPU
    tensors, one launch of the group's generated kernel for CUDA tensors
    (the plan's field must be F's)."""
    if out.device.type == "cpu":
        return run_group_plain(F, plan, g, tables, scalars, blowup, row0,
                               nrows, out, accumulate)
    if F.NAME != plan.field:
        raise ValueError(f"air_group: a plan rendered for {plan.field} "
                         f"run over {F.NAME}")
    L = F.NLIMBS
    align = _native.FIELD_KERNELS[L]["align"]
    _native.check_cuda_tensor(out, "air_group out", last_dim=L, align=align)
    _native.check_cuda_tensor(scalars, "air_group scalars", last_dim=L,
                              align=align)
    if len(tables) != len(plan.tables) or scalars.shape[0] < plan.scalar_rows:
        raise ValueError(f"air_group: {len(tables)} tables and "
                         f"{scalars.shape[0]} scalar rows for a plan of "
                         f"{len(plan.tables)} and {plan.scalar_rows}")
    check_group_tables(out, tables, plan.N, nrows, L)
    fns = _native.generated_lib(
        plan.stem, plan.sources,
        [f"{ENTRY}{k}" for k in range(len(plan.groups))], _ARGTYPES)
    arr = _native.ctypes.c_longlong * len(tables)
    _native.launch(COUNTER[plan.field], out.device,
                   arr(*[t.data_ptr() for t in tables]),
                   arr(*[t.shape[0] - 1 for t in tables]),
                   arr(*[t.stride(0) for t in tables]),
                   scalars.data_ptr(), plan.N, blowup, row0, nrows,
                   int(accumulate), out.data_ptr(), fn=fns[g])
