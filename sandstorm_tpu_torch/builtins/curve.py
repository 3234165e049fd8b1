"""The Starkware elliptic curve y^2 = x^3 + alpha*x + beta over Fp252 (copy
of the affine host arithmetic of sandstorm_tpu/builtins/curve.py).

Python-int affine points; None is the point at infinity.  The port uses
them to build the Pedersen window tables and in the tests.
"""

P = (1 << 251) + 17 * (1 << 192) + 1
ALPHA = 1
BETA = 3141592653589793238462643383279502884197169399375105820974944592307816406665


def calculate_slope(p1, p2) -> int:
    """Slope of the line through p1, p2 (tangent if equal); None if
    vertical.  Inverts with pow(x, -1, P) (extended Euclid), which is far
    faster than the Fermat power and gives the same value."""
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        return (3 * x1 * x1 + ALPHA) * pow(2 * y1, -1, P) % P
    return (y2 - y1) * pow(x2 - x1, -1, P) % P


def ec_add(p1, p2):
    """Affine addition (None = infinity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    s = calculate_slope(p1, p2)
    if s is None:
        return None
    x1, y1 = p1
    x2, y2 = p2
    x3 = (s * s - x1 - x2) % P
    y3 = (s * (x1 - x3) - y1) % P
    return (x3, y3)


def ec_double(pt):
    return ec_add(pt, pt)


def ec_mul(k: int, pt):
    """Scalar multiplication (double-and-add)."""
    acc = None
    addend = pt
    while k:
        if k & 1:
            acc = ec_add(acc, addend)
        addend = ec_double(addend)
        k >>= 1
    return acc


def doublings(pt, count: int):
    """[pt, 2pt, 4pt, ...] (count entries)."""
    out = [pt]
    for _ in range(count - 1):
        out.append(ec_double(out[-1]))
    return out
