"""The StarkWare Pedersen hash (trimmed copy of
sandstorm_tpu/builtins/pedersen.py: the hash, not the builtin's witness).

hash(a, b) = x-coordinate of P0 + a_low*P1 + a_high*P2 + b_low*P3 +
b_high*P4, with low = the 248 low bits and high = the 4 bits above them.
P0..P4 are the "P" entry of sandstorm_tpu/builtins/data/pedersen_points.json
(StarkWare's parameters, derived from the digits of pi).
"""

import functools

from . import curve

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


def process_element(x: int, which: int, start):
    """start + x_low * p_low + x_high * p_high via the doubling chain."""
    chain = _chain(which)
    acc = start
    for i in range(LOW_BITS + HIGH_BITS):
        if (x >> i) & 1:
            acc = curve.ec_add(acc, chain[i])
    return acc


def pedersen_hash(a: int, b: int) -> int:
    """Pedersen hash of two felts through the native C++ batch.  A failed
    build raises: the port has no silent drop to the python walk."""
    from .. import native
    return native.pedersen_hash_pairs_ints([a], [b])[0]


def pedersen_hash_oracle(a: int, b: int) -> int:
    """Pure-python Pedersen, bit by bit (the tests' oracle)."""
    acc = process_element(a, 0, P0)
    acc = process_element(b, 1, acc)
    return acc[0]
