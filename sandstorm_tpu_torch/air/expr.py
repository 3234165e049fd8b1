"""Symbolic AIR constraint expressions and their evaluators (PyTorch port of
sandstorm_tpu/air/expr.py).

Leaves are X, Constant, Trace(col, offset), Challenge(i), Hint(i),
Periodic(i); ops
are +, -, *, /, pow.  Hash-consing interns structurally
identical nodes, so the DAG is deduplicated and evaluation memoizes.  The
same DAG serves:

- evaluate_lde: evaluation over the LDE coset on a device, each node one
  elementwise field op (the Fp252 kernels on a CUDA tensor), folded into
  the composition polynomial as the constraints stream out; over the whole
  domain at once or in aligned windows of it (chunk_size);
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
