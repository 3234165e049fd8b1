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
depends on the DAG's shape alone: node numbers are positions in walk()
order, tables and scalars are numbered by first use.
"""

import hashlib
import heapq
import math

import torch

from .. import _native
from .expr import IntContext, _domain_only_invs, evaluate_int, walk

THREADS = 128          # threads a block of a group kernel
ENTRY = "air_groups"   # the C entry of every generated library
# C entry: group, table pointers / masks / row strides (host int64 arrays),
# scalars, N, blowup, first row, rows, accumulate, out (+ stream)
_ARGTYPES = [_native._I, _native._P, _native._P, _native._P, _native._P,
             _native._L, _native._L, _native._L, _native._L, _native._I,
             _native._P, _native._P]


class Group:
    """One group's program: its instructions and slot count."""

    __slots__ = ("code", "nslots")

    def __init__(self, code, nslots):
        self.code = code
        self.nslots = nslots


class Plan:
    """The lowered DAG: `scalars` (the scalar subtrees, rows 0.. of the
    scalar buffer; the fold coefficients follow them), `tables` (("trace",
    col) | ("x", e, period) | ("periodic", i) | ("hoist", node number)),
    `hoisted` (node number -> node), `groups`, and the CUDA `source` with
    its library `stem`."""

    def __init__(self, N, scalars, tables, hoisted, groups):
        self.N = N
        self.scalars = scalars
        self.tables = tables
        self.hoisted = hoisted
        self.groups = groups
        self.source = render(self)
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


def lower(exprs, N: int, periodic_periods, group_size: int = 8) -> Plan:
    """Lower the constraints `exprs` (folded in this order) for a domain of
    N rows, the periodic columns of the given periods, `group_size`
    constraints a group.  A prover lowers the same DAG in every prove:
    plans are kept for the process, keyed by the roots' identities (nodes
    are hash-consed and interned for the process, so an identity is never
    reused)."""
    key = (tuple(map(id, exprs)), N, tuple(periodic_periods), group_size)
    if key not in _PLANS:
        _PLANS[key] = _lower(exprs, N, periodic_periods, group_size)
    return _PLANS[key]


def _lower(exprs, N, periodic_periods, group_size):
    nodes = walk(exprs)
    number = {id(n): i for i, n in enumerate(nodes)}
    kind, period = _classify(nodes, N, periodic_periods)
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
    return Plan(N, scalars, tables, hoisted, groups)


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


def air_plan(air, n: int, blowup: int, group_size: int = 8) -> Plan:
    """The plan a prove of the layout `air` at trace length n and LDE
    blowup lowers (its periodic columns have period N / exponent on the
    LDE domain): what a caller builds ahead of the prove."""
    p = 2 ** 251 + 17 * 2 ** 192 + 1
    g = pow(3, (p - 1) // n, p)
    cons = air.constraints(n, p, g, base_modulus=p)
    pcs = air.periodic_columns(n) if hasattr(air, "periodic_columns") else []
    N = n * blowup
    return lower(cons, N, [N // pc.exponent for pc in pcs], group_size)


def build(plans) -> dict:
    """Build the plans' libraries that are missing, one nvcc each, all at
    once: {stem: _native.build_generated's record}."""
    return _native.build_generated({pl.stem: pl.source for pl in plans})


def scalar_values(plan, p: int, challenges, hints):
    """The scalar subtrees' values (python ints) for these challenges and
    hints."""
    return evaluate_int(plan.scalars, IntContext(p, None, {}, challenges,
                                                 hints))


# -- rendering ----------------------------------------------------------------

def _arg(o):
    if o[0] == "r":
        return f"r{o[1]}"
    if o[0] == "s":
        return f"LS({o[1]})"
    if o[0] == "t":
        return f"LT({o[1]}, {o[2]})"
    return f"LP({o[1]})"


def render(plan) -> str:
    """The CUDA source of a plan: one __global__ a group, one C entry."""
    nt = max(len(plan.tables), 1)
    out = [
        "// Generated by sandstorm_tpu_torch/air/codegen.py: the constraint",
        f"// groups of one AIR ({len(plan.groups)} groups, {nt} tables).",
        "#include <cuda_runtime.h>",
        "",
        '#include "fp252.cuh"',
        "",
        "namespace {",
        "",
        f"constexpr int NT = {nt};",
        "struct Tabs {",
        "  const uint32_t* p[NT];",
        "  long long m[NT];",
        "  long long st[NT];",
        "};",
        "",
        "// one montmul out of line: the groups call it hundreds of times",
        "__device__ __noinline__ fp::F M(const fp::F a, const fp::F b) {",
        "  return fp::mul(a, b);",
        "}",
        "",
        "#define LT(t, off) fp::load(tabs.p[t] + "
        "((row + (long long)(off) * blowup) & nmask) * tabs.st[t])",
        "#define LP(t) fp::load(tabs.p[t] + (row & tabs.m[t]) * tabs.st[t])",
        "#define LS(s) fp::load(S + (long long)(s) * 8)",
    ]
    for g, grp in enumerate(plan.groups):
        out += [
            "",
            f"__global__ void __launch_bounds__({THREADS})",
            f"g{g}(const __grid_constant__ Tabs tabs, "
            "const uint32_t* __restrict__ S, long long nmask,",
            "    long long blowup, long long row0, long long nrows, "
            "int accumulate,",
            "    uint32_t* __restrict__ out) {",
            f"  const long long i = (long long)blockIdx.x * {THREADS} "
            "+ threadIdx.x;",
            "  if (i >= nrows) return;",
            "  const long long row = row0 + i;",
        ]
        if grp.nslots:
            out.append("  fp::F " + ", ".join(
                f"r{k}" for k in range(grp.nslots)) + ";")
        out.append("  fp::F acc;")
        first = True
        for ins in grp.code:
            op = ins[0]
            if op == "fold":
                term = f"M(LS({ins[2]}), {_arg(ins[1])})"
                out.append(f"  acc = {term};  // fold {ins[3]}" if first else
                           f"  acc = fp::add(acc, {term});  // fold {ins[3]}")
                first = False
            elif op == "neg":
                out.append(f"  r{ins[1]} = fp::sub(fp::zero(), "
                           f"{_arg(ins[2])});  // n{ins[3]} neg")
            else:
                fn = "M" if op == "mul" else f"fp::{op}"
                out.append(f"  r{ins[1]} = {fn}({_arg(ins[2])}, "
                           f"{_arg(ins[3])});  // n{ins[4]} {op}")
        out += ["  if (accumulate) acc = fp::add(fp::load(out + i * 8), acc);",
                "  fp::store(out + i * 8, acc);",
                "}"]
    out += [
        "",
        "}  // namespace",
        "",
        f'extern "C" int {ENTRY}(int group, const long long* ptrs,',
        "    const long long* masks, const long long* strides, "
        "const void* S, long long N,",
        "    long long blowup, long long row0, long long nrows, "
        "int accumulate, void* out,",
        "    void* stream) {",
        "  Tabs tabs;",
        "  for (int t = 0; t < NT; t++) {",
        "    tabs.p[t] = (const uint32_t*)ptrs[t];",
        "    tabs.m[t] = masks[t];",
        "    tabs.st[t] = strides[t];",
        "  }",
        "  if (nrows <= 0) return (int)cudaGetLastError();",
        f"  const unsigned blocks = (unsigned)((nrows + {THREADS - 1}) "
        f"/ {THREADS});",
        "  cudaStream_t s = (cudaStream_t)stream;",
        "  switch (group) {",
    ]
    for g in range(len(plan.groups)):
        out.append(f"    case {g}: g{g}<<<blocks, {THREADS}, 0, s>>>(tabs, "
                   "(const uint32_t*)S, N - 1, blowup, row0, nrows, "
                   "accumulate, (uint32_t*)out); break;")
    out += ["    default: return -1;",
            "  }",
            "  return (int)cudaGetLastError();",
            "}",
            ""]
    return "\n".join(out)


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


def run_group(F, plan, g, tables, scalars, blowup, row0, nrows, out,
              accumulate):
    """Group g of the plan over rows row0 .. row0 + nrows, written (or with
    `accumulate` added) into out [nrows, L]: the plain version for CPU
    tensors, one launch of the group's generated kernel for CUDA
    tensors."""
    if out.device.type == "cpu":
        return run_group_plain(F, plan, g, tables, scalars, blowup, row0,
                               nrows, out, accumulate)
    if F.NAME != "fp252":
        raise ValueError(f"air_group: the kernels are Fp252's, not "
                         f"{F.NAME}'s")
    _native.check_cuda_tensor(out, "air_group out", last_dim=8)
    _native.check_cuda_tensor(scalars, "air_group scalars", last_dim=8)
    for t in tables:
        if t.device != out.device or t.dtype != torch.int32 \
                or t.shape[-1] != 8 or t.stride(1) != 1 \
                or t.stride(0) % 4 or t.data_ptr() % 16:
            raise ValueError("air_group: a table is not rows of 8 int32 "
                             "words, 16-byte aligned, on the output's device")
    fn = _native.generated_lib(plan.stem, plan.source, ENTRY, _ARGTYPES)
    arr = _native.ctypes.c_longlong * len(tables)
    _native.launch("air_group", out.device, g,
                   arr(*[t.data_ptr() for t in tables]),
                   arr(*[t.shape[0] - 1 for t in tables]),
                   arr(*[t.stride(0) for t in tables]),
                   scalars.data_ptr(), plan.N, blowup, row0, nrows,
                   int(accumulate), out.data_ptr(), fn=fn)
