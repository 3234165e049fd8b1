"""The StarkWare Pedersen hash in python ints (the reference's own; the
program hashes on the card and in C++).

hash(a, b) = x(P0 + a_low*P1 + a_high*P2 + b_low*P3 + b_high*P4), low = the
248 low bits, high = the 4 above them; P0..P4 as in the port's
builtins/pedersen.py.  The sum is taken in Jacobian coordinates over 8-bit
windows of precomputed affine multiples (one inversion a hash), which gives
the same point as the bit-by-bit affine walk (pedersen_hash_oracle) since
the group law is associative.  periodic_table_points is the doubling-chain
table the recursive and starknet layouts' periodic columns interpolate.
"""

import functools

from . import curve
from .curve import P

P0 = (
    2089986280348253421170679821480865132823066470938446095505822317253594081284,
    1713931329540660377023406109199410414810705867260802078187082345529207694986)
P1 = (
    996781205833008774514500082376783249102396023663454813447423147977397232763,
    1668503676786377725805489344771023921079126552019160156920634619255970485781)
P2 = (
    2251563274489750535117886426533222435294046428347329203627021249169616184184,
    1798716007562728905295480679789526322175868328062420237419143593021674992973)
P3 = (
    2138414695194151160943305727036575959195309218611738193261179310511854807447,
    113410276730064486255102093846540133784865286929052426931474106396135072156)
P4 = (
    2379962749567351885752724891227938183011949129833673362440656643086021394946,
    776496453633298175483985398648758586525933812536653089401905292063708816422)

LOW_BITS = 248
HIGH_BITS = 4
N_ELEMENT_STEPS = 256

WINDOW = 8


def shift_and_table_points():
    """(P0, P1, P2, P3, P4): the shift point and the two (low, high) pairs of
    base points, for the first and the second input."""
    return P0, P1, P2, P3, P4


@functools.lru_cache(maxsize=2)
def _chain(which: int):
    """Doubling chain of input `which`: 248 doublings of its low point, then
    4 of its high point (252 points)."""
    p_low, p_high = ((P1, P2), (P3, P4))[which]
    return (curve.doublings(p_low, LOW_BITS)
            + curve.doublings(p_high, HIGH_BITS))


def periodic_table_points(which: int):
    """The doubling-chain coordinates the periodic columns interpolate: 256
    rows per input, the 248 doublings of its low point, the 4 of its high
    point, then the last point repeated."""
    chain = _chain(which)
    return list(chain) + [chain[-1]] * (256 - len(chain))


def pedersen_hash_oracle(a: int, b: int) -> int:
    """Bit by bit in affine coordinates (the tests' oracle)."""
    acc = P0
    for which, x in ((0, a), (1, b)):
        chain = _chain(which)
        for i in range(LOW_BITS + HIGH_BITS):
            if (x >> i) & 1:
                acc = curve.ec_add(acc, chain[i])
    return acc[0]


@functools.lru_cache(maxsize=1)
def _tables():
    """For each input, its windows of WINDOW bits over the 252 bits: the
    affine multiples j * 2^(w WINDOW) * base, j = 0 .. 2^WINDOW - 1 (None
    for j = 0), the base switching from the low point to the high one at
    bit 248 (the high window holds 4 bits)."""
    out = []
    for which in (0, 1):
        chain = _chain(which)
        windows = []
        for start in range(0, LOW_BITS + HIGH_BITS, WINDOW):
            bits = min(WINDOW, LOW_BITS - start) if start < LOW_BITS \
                else HIGH_BITS
            base = chain[start]
            row = [None, base]
            for _ in range(2, 1 << bits):
                row.append(curve.ec_add(row[-1], base))
            windows.append((start, bits, row))
        out.append(windows)
    return out


def _jdouble(X1, Y1, Z1):
    if Y1 == 0:
        return (1, 1, 0)
    XX, YY, ZZ = X1 * X1 % P, Y1 * Y1 % P, Z1 * Z1 % P
    YYYY = YY * YY % P
    S = 2 * ((X1 + YY) ** 2 - XX - YYYY) % P
    M = (3 * XX + curve.ALPHA * ZZ * ZZ) % P
    X3 = (M * M - 2 * S) % P
    Y3 = (M * (S - X3) - 8 * YYYY) % P
    Z3 = ((Y1 + Z1) ** 2 - YY - ZZ) % P
    return (X3, Y3, Z3)


def _jadd_affine(J, pt):
    """Jacobian J plus affine pt (Z = 0 is the point at infinity)."""
    X1, Y1, Z1 = J
    x2, y2 = pt
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % P
    U2 = x2 * Z1Z1 % P
    S2 = y2 * Z1 % P * Z1Z1 % P
    H = (U2 - X1) % P
    r = 2 * (S2 - Y1) % P
    if H == 0:
        if r == 0:
            return _jdouble(X1, Y1, Z1)
        return (1, 1, 0)
    HH = H * H % P
    I = 4 * HH % P
    J_ = H * I % P
    V = X1 * I % P
    X3 = (r * r - J_ - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * Y1 * J_) % P
    Z3 = ((Z1 + H) ** 2 - Z1Z1 - HH) % P
    return (X3, Y3, Z3)


def pedersen_hash(a: int, b: int) -> int:
    """Pedersen hash of two felts below P."""
    J = (P0[0], P0[1], 1)
    for x, windows in zip((a, b), _tables()):
        for start, bits, row in windows:
            j = (x >> start) & ((1 << bits) - 1)
            if j:
                J = _jadd_affine(J, row[j])
    X, _, Z = J
    zi = pow(Z, -1, P)
    return X * zi % P * zi % P


def hash_chain(elements) -> int:
    """h(...h(h(0, e0), e1)..., count): the chain with a length tag."""
    curr, count = 0, 0
    for v in elements:
        curr = pedersen_hash(curr, int(v))
        count += 1
    return pedersen_hash(curr, count)
