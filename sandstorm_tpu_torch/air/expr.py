"""Symbolic AIR constraint expressions and their evaluators (PyTorch port of
sandstorm_tpu/air/expr.py).

Leaves are X, Constant, Trace(col, offset), Challenge(i), Hint(i),
Periodic(i); ops
are +, -, *, /, pow.  Hash-consing interns structurally
identical nodes, so the DAG is deduplicated and evaluation memoizes.  The
same DAG serves:

- evaluate_lde: whole-domain evaluation over the LDE coset on a device,
  each node one elementwise field op (the Fp252 kernels on a CUDA tensor),
  folded into the composition polynomial as the constraints stream out;
- evaluate_int: host evaluation at the OODS point with python ints.

Division is multiplication by an Inv node; inverses of domain-length
denominators are batch-inverted, and X^k zerofiers are evaluated on their
short period and only broadcast up when they meet a full-length value.
"""

import math

import torch

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
        self.memo = {}


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


def evaluate_lde(exprs, ctx: LdeContext, domain_size: int = None, fold=None):
    """Evaluate expressions over the whole LDE domain; returns a list of
    [N, L] tensors, or with `fold` the accumulator of
    acc = fold(acc, value, index) over the expressions in order.

    Values are tracked as (array, period) pairs: X^e subexpressions and
    periodic columns are periodic over the domain (X^e with period
    N / gcd(N, e)), so zerofiers are built and batch-inverted on their short
    period.  Interior values are
    reference-counted and dropped from the memo after their last consumer,
    so peak memory is the live set, not the whole DAG.
    """
    F = ctx.F
    memo = ctx.memo
    N = domain_size
    if N is None:
        N = next(iter(ctx.columns.values())).shape[0]
    device = next(iter(ctx.columns.values())).device

    # reference counts over the hash-consed DAG (+1 per root occurrence)
    refs = {}
    for node in walk(exprs):
        for child in node.args:
            refs[id(child)] = refs.get(id(child), 0) + 1
    for e in exprs:
        refs[id(e)] = refs.get(id(e), 0) + 1

    def consume(n):
        """Fetch n's value and release one reference to it (trace leaves
        are never memoized, see ev)."""
        if id(n) not in memo:
            return ev(n)
        r = memo[id(n)]
        refs[id(n)] -= 1
        if refs[id(n)] == 0:
            del memo[id(n)]
        return r

    def ev(n):
        r = memo.get(id(n))
        if r is not None:
            return r
        k = n.key
        op = k[0]
        if op == "X":
            r = (ctx.domain_fn(), N)
        elif op == "const":
            r = (F.encode_int(k[1], device), 0)
        elif op == "trace":
            # not memoized: a rolled copy is domain-length, and dozens of
            # distinct (col, offset) leaves would stay live across the whole
            # constraint set -- recompute the roll per consumer instead
            col, off = k[1], k[2]
            arr = ctx.columns[col]
            shift = (off * ctx.blowup) % arr.shape[0]
            return (torch.roll(arr, -shift, 0) if shift else arr, N)
        elif op == "challenge":
            r = (ctx.challenges[k[1]], 0)
        elif op == "hint":
            r = (ctx.hints[k[1]], 0)
        elif op == "periodic":
            arr = ctx.periodic[k[1]]()
            r = (arr, arr.shape[0])
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
                period = N // math.gcd(N, e)
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
        memo[id(n)] = r
        return r

    acc = None
    out = []
    for i, e in enumerate(exprs):
        ev(e)
        v, p = consume(e)
        v = _tile_to(v, p, N)
        if fold is None:
            out.append(v)
        else:
            acc = fold(acc, v, i)
    return out if fold is None else acc


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
