"""Frozen copy of the symbolic constraint DAG of sandstorm_tpu_torch/air/expr.py
(leaves X, Constant, Trace, Challenge, Hint, Periodic; +, -, *, /, pow;
hash-consed nodes) and of its host evaluator evaluate_int, which the
reference verifier runs at the OODS point with python ints."""

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
