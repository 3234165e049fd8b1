"""Symbolic AIR constraint expressions and their evaluators (PyTorch port of
sandstorm_tpu/air/expr.py).

Leaves are X, Constant, Trace(col, offset), Challenge(i), Hint(i),
Periodic(i); ops
are +, -, *, /, pow.  Hash-consing interns structurally
identical nodes, so the DAG is deduplicated and evaluation memoizes.  The
same DAG serves:

- evaluate_lde: evaluation over the LDE coset on a device, each node one
  elementwise field op (the field's kernels on a CUDA tensor), folded into
  the composition polynomial as the constraints stream out; over the whole
  domain at once or in aligned windows of it (chunk_size);
- evaluate_lde_folded: the same fold with each group of constraints one
  program (air/codegen.py): one generated kernel launch a group on a CUDA
  tensor (Fp252, Goldilocks, GF(p^3)), with the zerofier inverses and the
  short-period subtrees hoisted out of the groups and computed once; its
  plain version, an interpreter of the same programs, on CPU tensors;
- evaluate_int: host evaluation at the OODS point with python ints.

Division is multiplication by an Inv node; inverses of domain-length
denominators are batch-inverted, and X^k zerofiers are evaluated on their
short period and only broadcast up when they meet a full-length value.
"""

import math

import torch

from ..fields.scan import batch_inv_many

_INTERN = {}


def _intern(node):
    got = _INTERN.get(node.key)
    if got is not None:
        return got
    _INTERN[node.key] = node
    return node


class Expr:
    """Base class. Subclasses define .key (structural identity) and .args."""

    __slots__ = ("key", "args")

    def __init__(self, key, args=()):
        self.key = key
        self.args = args

    # -- operator sugar ----------------------------------------------------

    def __add__(self, other):
        return Add(self, _coerce(other))

    def __radd__(self, other):
        return Add(_coerce(other), self)

    def __sub__(self, other):
        return Sub(self, _coerce(other))

    def __rsub__(self, other):
        return Sub(_coerce(other), self)

    def __mul__(self, other):
        return Mul(self, _coerce(other))

    def __rmul__(self, other):
        return Mul(_coerce(other), self)

    def __truediv__(self, other):
        return Mul(self, Inv(_coerce(other)))

    def __rtruediv__(self, other):
        return Mul(_coerce(other), Inv(self))

    def __neg__(self):
        return Neg(self)

    def pow(self, e: int):
        return Pow(self, int(e))

    __pow__ = pow

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return self is other or (isinstance(other, Expr) and self.key == other.key)


def _coerce(v):
    if isinstance(v, Expr):
        return v
    if isinstance(v, int):
        return Constant(v)
    raise TypeError(f"cannot coerce {type(v)} to Expr")


# -- leaves -----------------------------------------------------------------

class _X(Expr):
    def __init__(self):
        super().__init__(("X",))


X = _intern(_X())


def Constant(value: int):
    node = Expr.__new__(Expr)
    Expr.__init__(node, ("const", int(value)))
    node = _intern(node)
    return node


def Trace(col: int, offset: int):
    node = Expr.__new__(Expr)
    Expr.__init__(node, ("trace", int(col), int(offset)))
    return _intern(node)


def Challenge(index: int):
    node = Expr.__new__(Expr)
    Expr.__init__(node, ("challenge", int(index)))
    return _intern(node)


def Hint(index: int):
    node = Expr.__new__(Expr)
    Expr.__init__(node, ("hint", int(index)))
    return _intern(node)


def Periodic(index: int):
    """A periodic column: an index into the layout's list of periodic
    columns (layouts/utils.py PeriodicColumn)."""
    node = Expr.__new__(Expr)
    Expr.__init__(node, ("periodic", int(index)))
    return _intern(node)


# -- interior nodes ----------------------------------------------------------

def _binop(name, a, b):
    node = Expr.__new__(Expr)
    Expr.__init__(node, (name, a.key, b.key), (a, b))
    return _intern(node)


def Add(a, b):
    return _binop("add", a, b)


def Sub(a, b):
    return _binop("sub", a, b)


def Mul(a, b):
    return _binop("mul", a, b)


def Neg(a):
    node = Expr.__new__(Expr)
    Expr.__init__(node, ("neg", a.key), (a,))
    return _intern(node)


def Pow(a, e: int):
    node = Expr.__new__(Expr)
    Expr.__init__(node, ("pow", a.key, int(e)), (a,))  # exponent = key[2]
    return _intern(node)


def Inv(a):
    node = Expr.__new__(Expr)
    Expr.__init__(node, ("inv", a.key), (a,))
    return _intern(node)


# -- analysis ----------------------------------------------------------------

def walk(exprs):
    """Yield every unique node reachable from exprs (post-order)."""
    seen = set()
    out = []

    def rec(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for a in n.args:
            rec(a)
        out.append(n)

    for e in exprs:
        rec(e)
    return out


def trace_arguments(exprs):
    """Sorted set of (column, offset) pairs used by the expressions.

    The analog of miniSTARK Air::trace_arguments() (src/lib.rs:105-110):
    determines which out-of-domain trace evaluations the proof must supply.
    """
    args = set()
    for n in walk(exprs):
        if n.key[0] == "trace":
            args.add((n.key[1], n.key[2]))
    return sorted(args)


# -- evaluation over the LDE domain -------------------------------------------

class LdeContext:
    """Everything needed to evaluate constraints over the LDE domain.

    - F: field class
    - columns: dict col_index -> [N, L] LDE evaluations (natural order)
    - blowup: LDE blowup factor (trace offset k => roll by k * blowup)
    - domain_fn: () -> [N, L] domain points (coset * w^i)
    - x_pow_fn: (e, period) -> [period, L] array of domain^e
    - challenges / hints: lists of [L] tensors
    - periodic: list of callables () -> [period, L] values of each periodic
      column on the domain (period a power of two dividing N)
    """

    def __init__(self, F, columns, blowup, domain_fn, x_pow_fn,
                 challenges=(), hints=(), periodic=()):
        self.F = F
        self.columns = columns
        self.blowup = blowup
        self.domain_fn = domain_fn
        self.x_pow_fn = x_pow_fn
        self.challenges = challenges
        self.hints = hints
        self.periodic = periodic


def _tile_to(val, period, target):
    """A (value, period) pair as a [target, L] array (period 0 = scalar)."""
    if period == target:
        return val
    if period == 0:
        return val.expand((target,) + tuple(val.shape))
    return val.repeat(target // period, 1)


def _combine(op_fn, a, pa, b, pb):
    """op of two (value, period) pairs.  Periods are powers of two (or 0 for
    a scalar); the shorter period is broadcast over the longer one through
    a [long / short, short] view instead of a tiled copy."""
    p = max(pa, pb)
    if pa == pb or 0 in (pa, pb):
        return op_fn(a, b), p
    L = a.shape[-1]
    if pa < pb:
        out = op_fn(a[None], b.reshape(pb // pa, pa, L))
    else:
        out = op_fn(a.reshape(pa // pb, pb, L), b[None])
    return out.reshape(p, L), p


def evaluate_lde(exprs, ctx: LdeContext, domain_size: int = None, fold=None,
                 chunk_size: int = None):
    """Evaluate expressions over the LDE domain; returns a list of [N, L]
    tensors, or with `fold` the accumulator of acc = fold(acc, value,
    index) over the expressions in order.

    Values are tracked as (array, period) pairs: X^e subexpressions and
    periodic columns are periodic over the domain (X^e with period
    N / gcd(N, e)), so zerofiers are built and batch-inverted on their short
    period.  Interior values are reference-counted and dropped from the
    memo after their last consumer, so peak memory is the live set, not
    the whole DAG.

    With a `chunk_size` B below N (and a `fold`), the domain is taken in
    B-row windows, so that every live value is [B, L] and not [N, L].  The
    windows are aligned (B divides s), so a value of period at most B (a
    periodic column, a short-period X^e, and whatever is made of them
    alone, the zerofier inverses among them) is the same in every window:
    those are computed once and kept across the windows.  The rest (trace
    values, long-period powers of X and what is made of them) is evaluated
    per window, a trace value as a slice of its column that wraps around
    the domain's end, with the same reference counting.  The windows' folds
    are concatenated; the values are those of the whole-domain evaluation.
    """
    F = ctx.F
    N = domain_size
    if N is None:
        N = next(iter(ctx.columns.values())).shape[0]
    device = next(iter(ctx.columns.values())).device
    B = N if chunk_size is None else min(chunk_size, N)
    assert N % B == 0 and (B == N or fold is not None)
    nodes = walk(exprs)

    # reference counts over the hash-consed DAG (+1 per root occurrence)
    refs = {}
    for node in nodes:
        for child in node.args:
            refs[id(child)] = refs.get(id(child), 0) + 1
    for e in exprs:
        refs[id(e)] = refs.get(id(e), 0) + 1

    periodic_vals = {}

    def periodic(i):
        if i not in periodic_vals:
            periodic_vals[i] = ctx.periodic[i]()
        return periodic_vals[i]

    def x_period(e):
        return N // math.gcd(N, e)

    # chunk variance: whether a node's value differs between windows
    variant = {}
    for n in nodes:
        op = n.key[0]
        if op in ("X", "trace"):
            variant[id(n)] = True
        elif op == "pow" and n.args[0].key[0] == "X":
            variant[id(n)] = x_period(n.key[2]) > B
        elif op == "periodic":
            variant[id(n)] = periodic(n.key[1]).shape[0] > B
        elif op in ("const", "challenge", "hint"):
            variant[id(n)] = False
        else:
            variant[id(n)] = any(variant[id(a)] for a in n.args)
    # the chunk-invariant values, kept across windows (with one window the
    # reference counting alone decides)
    kept = {} if B < N else None

    def window(arr, period, s):
        """Rows s..s+B of a whole-domain value of `period` (> B)."""
        start = s % period
        return arr[start:start + B]

    def evaluate_window(s):
        memo = {}
        left = dict(refs)

        def consume(n):
            """Fetch n's value and release one reference to it (trace
            leaves and kept values are not in the memo, see ev)."""
            if id(n) not in memo:
                return ev(n)
            r = memo[id(n)]
            left[id(n)] -= 1
            if left[id(n)] == 0:
                del memo[id(n)]
            return r

        def ev(n):
            r = memo.get(id(n))
            if r is None and kept is not None:
                r = kept.get(id(n))
            if r is not None:
                return r
            k = n.key
            op = k[0]
            if op == "X":
                r = (window(ctx.domain_fn(), N, s), B)
            elif op == "const":
                r = (F.encode_int(k[1], device), 0)
            elif op == "trace":
                # not memoized: a trace value is a view of its column unless
                # it wraps around the domain's end -- copy such a slice per
                # consumer rather than keep dozens of them live
                arr = ctx.columns[k[1]]
                start = (s + k[2] * ctx.blowup) % N
                if start + B <= N:
                    return (arr[start:start + B], B)
                return (torch.cat([arr[start:], arr[:start + B - N]]), B)
            elif op == "challenge":
                r = (ctx.challenges[k[1]], 0)
            elif op == "hint":
                r = (ctx.hints[k[1]], 0)
            elif op == "periodic":
                arr = periodic(k[1])
                r = (window(arr, arr.shape[0], s), B) if variant[id(n)] \
                    else (arr, arr.shape[0])
            elif op in ("add", "sub", "mul"):
                ev(n.args[0])
                ev(n.args[1])
                a, pa = consume(n.args[0])
                b, pb = consume(n.args[1])
                r = _combine(getattr(F, op), a, pa, b, pb)
            elif op == "neg":
                ev(n.args[0])
                a, pa = consume(n.args[0])
                r = (F.neg(a), pa)
            elif op == "pow":
                e = k[2]
                base = n.args[0]
                if base.key[0] == "X":
                    period = x_period(e)
                    if period > B:
                        r = (window(ctx.x_pow_fn(e, period), period, s), B)
                    else:
                        r = (ctx.x_pow_fn(e, period), period)
                else:
                    ev(base)
                    a, pa = consume(base)
                    r = (F.pow_static(a, e), pa)
            elif op == "inv":
                ev(n.args[0])
                v, pv = consume(n.args[0])
                r = (F.inv(v), 0) if pv == 0 else (F.batch_inv(v, axis=0), pv)
            else:  # pragma: no cover
                raise ValueError(f"unknown node {op}")
            if kept is not None and not variant[id(n)]:
                kept[id(n)] = r
            else:
                memo[id(n)] = r
            return r

        acc = None
        out = []
        for i, e in enumerate(exprs):
            ev(e)
            v, p = consume(e)
            v = _tile_to(v, p, B)
            if fold is None:
                out.append(v)
            else:
                acc = fold(acc, v, i)
        return out if fold is None else acc

    if B == N:
        return evaluate_window(0)
    first = evaluate_window(0)
    acc = torch.empty((N,) + tuple(first.shape[1:]), dtype=first.dtype,
                      device=first.device)
    acc[:B] = first
    del first
    for s in range(B, N, B):
        acc[s:s + B] = evaluate_window(s)
    return acc


# -- the grouped fold ------------------------------------------------------------

def _xpow_keys(exprs, N):
    """All (exponent, period) pairs of X-power leaves in the expressions."""
    keys = []
    for n_ in walk(exprs):
        if n_.key[0] == "X":
            keys.append((1, N))
        elif n_.key[0] == "pow" and n_.args[0].key[0] == "X":
            e = n_.key[2]
            keys.append((e, N // math.gcd(N, e)))
    return sorted(set(keys))


_DOMAIN_ONLY_OPS = {"X", "const", "pow", "add", "sub", "mul", "neg", "inv"}


def _domain_only_invs(exprs):
    """The inv nodes whose subtree is pure domain arithmetic (X / const
    leaves only): the zerofier inverses.  Their values depend on the field,
    N and the coset but not on the trace, so they are hoisted out of the
    groups and computed once."""
    dom = {}

    def is_dom(n_):
        got = dom.get(id(n_))
        if got is not None:
            return got
        ok = n_.key[0] in _DOMAIN_ONLY_OPS and all(is_dom(a)
                                                   for a in n_.args)
        dom[id(n_)] = ok
        return ok

    out, seen = [], set()
    for n_ in walk(exprs):
        if n_.key[0] == "inv" and n_.key not in seen and is_dom(n_):
            seen.add(n_.key)
            out.append(n_)
    return out


def _eval_domain_node(F, n_, x_pow_fn, N, memo, device):
    """Eager evaluation of a domain-only subtree -> (array, period): X
    powers from the caller's tables, everything else a few short-period
    field ops."""
    r = memo.get(id(n_))
    if r is not None:
        return r
    k = n_.key
    op = k[0]
    if op == "X":
        r = (x_pow_fn(1, N), N)
    elif op == "const":
        r = (F.encode_int(k[1], device), 0)
    elif op == "pow" and n_.args[0].key[0] == "X":
        period = N // math.gcd(N, k[2])
        r = (x_pow_fn(k[2], period), period)
    elif op in ("add", "sub", "mul"):
        a, pa = _eval_domain_node(F, n_.args[0], x_pow_fn, N, memo, device)
        b, pb = _eval_domain_node(F, n_.args[1], x_pow_fn, N, memo, device)
        r = _combine(getattr(F, op), a, pa, b, pb)
    elif op == "neg":
        a, pa = _eval_domain_node(F, n_.args[0], x_pow_fn, N, memo, device)
        r = (F.neg(a), pa)
    elif op == "pow":
        a, pa = _eval_domain_node(F, n_.args[0], x_pow_fn, N, memo, device)
        r = (F.pow_static(a, k[2]), pa)
    elif op == "inv":
        a, pa = _eval_domain_node(F, n_.args[0], x_pow_fn, N, memo, device)
        r = (F.inv(a), 0) if pa == 0 else (F.batch_inv(a, axis=0), pa)
    else:  # pragma: no cover
        raise ValueError(f"non-domain node {op}")
    memo[id(n_)] = r
    return r


def _domain_period(n_, N):
    """Structural period of a domain-only subtree (all periods divide N,
    so max == lcm; 0 = scalar)."""
    k = n_.key
    op = k[0]
    if op == "X":
        return N
    if op == "const":
        return 0
    if op == "pow" and n_.args[0].key[0] == "X":
        return N // math.gcd(N, k[2])
    return max((_domain_period(a, N) for a in n_.args), default=0)


def _hoisted_zinvs(F, exprs, ctx, N):
    """{node key -> (array, period)} for every domain-only inv node that is
    not a scalar (those are folded on the host), each on its period.  The
    arguments are evaluated first and inverted together, one batch_inv_many
    (one fp252_batch_inv or gl_batch_inv call on a CUDA tensor) a level: an inv node
    nested inside another's argument is a level below it.  The JAX package
    keeps them in a device cache across proves; here they live for one
    evaluation (a full-period one at N = 2^22 is 128 MiB)."""
    device = next(iter(ctx.columns.values())).device
    levels = {}

    def level(n_):
        """1 + the deepest level of a hoisted inv node below n_ (0: none)"""
        got = levels.get(id(n_))
        if got is None:
            got = max((level(a) for a in n_.args), default=0)
            if n_.key[0] == "inv" and _domain_period(n_, N):
                got += 1
            levels[id(n_)] = got
        return got

    nodes = [n_ for n_ in _domain_only_invs(exprs) if _domain_period(n_, N)]
    out, memo = {}, {}
    for lv in sorted({level(n_) for n_ in nodes}):
        now = [n_ for n_ in nodes if level(n_) == lv]
        args = [_eval_domain_node(F, n_.args[0], ctx.x_pow_fn, N, memo,
                                  device) for n_ in now]
        for n_, (a, pa), inv in zip(now, args,
                                    batch_inv_many(F, [a for a, _ in args])):
            memo[id(n_)] = (inv, pa)
            out[n_.key] = (inv, _domain_period(n_, N))
    return out


def _evaluate_periods(exprs, ctx, N, memo=None):
    """Eagerly evaluate expressions free of trace values and of X itself,
    returning (array, period) pairs WITHOUT tiling to the full domain (the
    hoisted tables of the grouped fold).  `memo` (by node id) may be seeded
    with values computed elsewhere, the zerofier inverses."""
    F = ctx.F
    device = next(iter(ctx.columns.values())).device
    memo = {} if memo is None else memo

    def ev(n_):
        r = memo.get(id(n_))
        if r is not None:
            return r
        k = n_.key
        op = k[0]
        if op == "const":
            r = (F.encode_int(k[1], device), 0)
        elif op == "challenge":
            r = (ctx.challenges[k[1]], 0)
        elif op == "hint":
            r = (ctx.hints[k[1]], 0)
        elif op == "periodic":
            arr = ctx.periodic[k[1]]()
            r = (arr, arr.shape[0])
        elif op in ("add", "sub", "mul"):
            a, pa = ev(n_.args[0])
            b, pb = ev(n_.args[1])
            r = _combine(getattr(F, op), a, pa, b, pb)
        elif op == "neg":
            a, pa = ev(n_.args[0])
            r = (F.neg(a), pa)
        elif op == "pow":
            e = k[2]
            if n_.args[0].key[0] == "X":
                period = N // math.gcd(N, e)
                r = (ctx.x_pow_fn(e, period), period)
            else:
                a, pa = ev(n_.args[0])
                r = (F.pow_static(a, e), pa)
        elif op == "inv":
            v, pv = ev(n_.args[0])
            r = (F.inv(v), 0) if pv == 0 else (F.batch_inv(v, axis=0), pv)
        else:  # pragma: no cover
            raise ValueError(f"invariant walker hit variant node {op}")
        memo[id(n_)] = r
        return r

    return [ev(e) for e in exprs]


def _fold_setup(exprs, ctx: LdeContext, N: int, fold_coeffs,
                group_size: int = 8, base_cols=()):
    """What the groups of evaluate_lde_folded read: (plan, tables, scalars)
    -- the lowered program (air/codegen.py; over GF(p^3) typed with the
    trace columns `base_cols` named base, which must hold base-field
    values: stark/prover.py checks its base trace once), a tensor for
    each of its tables (trace columns, X powers, periodic columns, and the
    hoisted zerofier inverses and short-period subtrees, computed here),
    and the scalar buffer (the scalar subtrees evaluated on the host with
    python ints, then the fold coefficients) on the columns' device."""
    from . import codegen
    F = ctx.F
    device = next(iter(ctx.columns.values())).device
    periodic = [pc() for pc in ctx.periodic]
    sub = LdeContext(F, ctx.columns, ctx.blowup, ctx.domain_fn, ctx.x_pow_fn,
                     ctx.challenges, ctx.hints,
                     [lambda v=v: v for v in periodic])
    plan = codegen.lower(exprs, N, [v.shape[0] for v in periodic],
                         group_size, F.NAME, base_cols)
    zinvs = _hoisted_zinvs(F, exprs, sub, N)
    memo = {id(n_): zinvs[n_.key] for n_ in walk(exprs) if n_.key in zinvs}
    nums = sorted(plan.hoisted)
    hoisted = dict(zip(nums, _evaluate_periods(
        [plan.hoisted[i] for i in nums], sub, N, memo)))
    tables = []
    for key in plan.tables:
        if key[0] == "trace":
            arr = ctx.columns[key[1]]
        elif key[0] == "x":
            arr = ctx.x_pow_fn(key[1], key[2])
        elif key[0] == "periodic":
            arr = periodic[key[1]]
        else:
            arr, period = hoisted[key[1]]
            assert period == arr.shape[0] > 0
        tables.append(arr)

    def ints(vals):
        return F.decode_ints(torch.stack(list(vals))) if len(vals) else []

    # every value enters through F.s: over GF(p^3) a packed int is not the
    # element, and a negative int is a base-field value
    scalars = F.encode_ints(
        codegen.scalar_values(plan, F, ints(ctx.challenges), ints(ctx.hints))
        + [F.s(c) for c in fold_coeffs], device)
    return plan, tables, scalars


def _fold_run(F, plan, tables, scalars, blowup, out, chunk_size=None):
    """Every group of the plan over the domain (or in windows of chunk_size
    rows), the first written into out [N, L], the others added."""
    from . import codegen
    N = out.shape[0]
    B = N if chunk_size is None else min(chunk_size, N)
    assert N % B == 0
    for s in range(0, N, B):
        for g in range(len(plan.groups)):
            codegen.run_group(F, plan, g, tables, scalars, blowup, s, B,
                              out[s:s + B], accumulate=g > 0)
    return out


def evaluate_lde_folded(exprs, ctx: LdeContext, N: int, fold_coeffs,
                        group_size: int = 8, chunk_size: int = None,
                        base_cols=()):
    """sum_i fold_coeffs[i] * exprs[i] over the LDE domain (the composition
    polynomial): the JAX package's evaluate_lde_folded and
    evaluate_lde_folded_chunked in one function.  Each group of
    `group_size` constraints is one program of air/codegen.py, run over
    the domain (or over windows of chunk_size rows: a program takes its
    first row as an argument, so windows change no value) and added into
    the result: one generated kernel launch a group and window on a CUDA
    tensor, the plain interpreter on CPU tensors.  Before the groups
    run, the zerofier inverses (_hoisted_zinvs) and every subtree of trace-
    free values of period below N (_evaluate_periods) are computed once on
    their periods, the scalar subtrees on the host with python ints
    (_fold_setup); they are dropped when it returns.

    fold_coeffs: python ints, one per constraint; base_cols: the trace
    columns holding base-field values (over GF(p^3) the kernels read them
    as one Goldilocks word; see _fold_setup).  Returns [N, L]."""
    F = ctx.F
    plan, tables, scalars = _fold_setup(exprs, ctx, N, fold_coeffs,
                                        group_size, base_cols)
    out = torch.empty((N, F.NLIMBS), dtype=torch.int32,
                      device=scalars.device)
    return _fold_run(F, plan, tables, scalars, ctx.blowup, out, chunk_size)


# -- host evaluation at a point -------------------------------------------------

class IntContext:
    """Host-side scalar evaluation with python big-ints (verifier path).

    - modulus: field modulus p
    - x: the evaluation point (int)
    - trace_values: dict (col, offset) -> int
    - challenges / hints: lists of ints
    - periodic_values: list of ints (the periodic columns at the point)
    - s: the leaf wrapper; an extension field passes its host-scalar
      constructor (F.s), so every value entering the DAG carries field
      semantics; by default values reduce mod p
    """

    def __init__(self, modulus, x, trace_values, challenges=(), hints=(),
                 periodic_values=(), s=None):
        self.p = modulus
        self.x = x
        self.trace_values = trace_values
        self.challenges = challenges
        self.hints = hints
        self.periodic_values = periodic_values
        self.s = s or (lambda v: int(v) % modulus)
        self.memo = {}


def evaluate_int(exprs, ctx: IntContext):
    """Evaluate expressions at a point using python ints (no device)."""
    p = ctx.p
    memo = ctx.memo
    s = ctx.s

    def ev(n):
        r = memo.get(id(n))
        if r is not None:
            return r
        k = n.key
        op = k[0]
        if op == "X":
            r = s(ctx.x)
        elif op == "const":
            r = s(k[1])
        elif op == "trace":
            r = s(ctx.trace_values[(k[1], k[2])])
        elif op == "challenge":
            r = s(ctx.challenges[k[1]])
        elif op == "hint":
            r = s(ctx.hints[k[1]])
        elif op == "periodic":
            r = s(ctx.periodic_values[k[1]])
        elif op == "add":
            r = (ev(n.args[0]) + ev(n.args[1])) % p
        elif op == "sub":
            r = (ev(n.args[0]) - ev(n.args[1])) % p
        elif op == "mul":
            r = ev(n.args[0]) * ev(n.args[1]) % p
        elif op == "neg":
            r = -ev(n.args[0]) % p
        elif op == "pow":
            r = pow(ev(n.args[0]), k[2], p)
        elif op == "inv":
            r = pow(ev(n.args[0]), p - 2, p)
        else:  # pragma: no cover
            raise ValueError(f"unknown node {op}")
        memo[id(n)] = r
        return r

    return [ev(e) for e in exprs]
