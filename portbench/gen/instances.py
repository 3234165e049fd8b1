"""Builtin instances drawn from a seed: frozen copies of the makers of the
port's claims.py (_made_up_*) and of the ECDSA and EC-op helpers they need
(builtins/ecdsa.py sign / verify / mimic_ec_mad_air, builtins/ec_op.py
mimic_ec_mad_air), so that the benchmark's jobs do not move when the
program changes.

Each maker takes a numpy Generator and returns the instance dicts of the
AIR private input JSON: Pedersen and bitwise inputs below 2^251, Poseidon
inputs below p, 128-bit range checks whose 16-bit parts lie in the VM's
[rc_min, rc_max], ECDSA signatures by one private key (each checked by the
AIR's own formula), and EC ops p + m q whose partial sums the AIR accepts.
The scalar products and the AIR's walks run in Jacobian coordinates (one
inversion a walk, where the program's affine helpers take two a step); they
give the same points, so the same instances.
"""

from ..reference.curve import ALPHA, FR, GENERATOR, P, ec_add, ec_neg, recover_y
from ..reference.pedersen import P0 as SHIFT_POINT


def draw(rng, bound: int) -> int:
    """A python int below `bound` (at most 2^256)."""
    return int.from_bytes(rng.bytes(32), "big") % bound


def hash_inputs(rng, count: int):
    """Pedersen and bitwise instances {"index", "x", "y"}: 251-bit inputs."""
    out = []
    for i in range(count):
        x, y = (int.from_bytes(rng.bytes(32), "big") >> 5 for _ in range(2))
        out.append({"index": i, "x": hex(x), "y": hex(y)})
    return out


def poseidons(rng, count: int):
    return [{"index": i, **{f"input_s{k}": hex(draw(rng, P))
                            for k in range(3)}} for i in range(count)]


def rc128(rng, count: int, lo: int, hi: int):
    """128-bit values whose eight 16-bit parts lie in [lo, hi]: they leave
    the VM's rc_min and rc_max as they are."""
    out = []
    for i in range(count):
        value = 0
        for part in rng.integers(lo, hi + 1, size=8):
            value = (value << 16) | int(part)
        out.append({"index": i, "value": hex(value)})
    return out


# -- Jacobian arithmetic: (X, Y, Z) is (X / Z^2, Y / Z^3); Z = 0 is infinity

INF = (1, 1, 0)


def _jdouble(J):
    X1, Y1, Z1 = J
    if Z1 == 0 or Y1 == 0:
        return INF
    XX, YY, ZZ = X1 * X1 % P, Y1 * Y1 % P, Z1 * Z1 % P
    YYYY = YY * YY % P
    S = 2 * ((X1 + YY) * (X1 + YY) - XX - YYYY) % P
    M = (3 * XX + ALPHA * ZZ * ZZ) % P
    X3 = (M * M - 2 * S) % P
    return (X3, (M * (S - X3) - 8 * YYYY) % P,
            ((Y1 + Z1) * (Y1 + Z1) - YY - ZZ) % P)


def _jadd(J1, J2):
    X1, Y1, Z1 = J1
    X2, Y2, Z2 = J2
    if Z1 == 0:
        return J2
    if Z2 == 0:
        return J1
    Z1Z1, Z2Z2 = Z1 * Z1 % P, Z2 * Z2 % P
    U1, U2 = X1 * Z2Z2 % P, X2 * Z1Z1 % P
    S1, S2 = Y1 * Z2 % P * Z2Z2 % P, Y2 * Z1 % P * Z1Z1 % P
    H = (U2 - U1) % P
    r = 2 * (S2 - S1) % P
    if H == 0:
        return _jdouble(J1) if r == 0 else INF
    I = 4 * H * H % P
    J = H * I % P
    V = U1 * I % P
    X3 = (r * r - J - 2 * V) % P
    return (X3, (r * (V - X3) - 2 * S1 * J) % P,
            ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P)


def _affine(J):
    X, Y, Z = J
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 % P * zi % P)


def _same_x(J1, J2) -> bool:
    return J1[0] * J2[2] * J2[2] % P == J2[0] * J1[2] * J1[2] % P


def ec_mul(k: int, pt):
    """k * pt (double-and-add)."""
    acc, addend = INF, (pt[0], pt[1], 1)
    while k:
        if k & 1:
            acc = _jadd(acc, addend)
        addend = _jdouble(addend)
        k >>= 1
    return _affine(acc)


def _ecdsa_mimic(m: int, point, shift):
    """shift + m * point with the AIR's failure modes: None when a partial
    sum shares its x-coordinate with the addend, or when m has 0 or 252
    and more bits."""
    if not (1 <= m.bit_length() < 252):
        return None
    return _ec_op_mimic(m, point, shift)


def _ec_op_mimic(m: int, q, p):
    """p + m q, None when a partial sum shares its x-coordinate with the
    addend."""
    partial, addend = (p[0], p[1], 1), (q[0], q[1], 1)
    while m:
        if _same_x(partial, addend):
            return None
        if m & 1:
            partial = _jadd(partial, addend)
        addend = _jdouble(addend)
        m >>= 1
    return _affine(partial)


def _sign(privkey: int, message: int, k: int):
    """(r, w) for the nonce k: r = x(k G), w = k / (message + r privkey) mod
    the curve order; None where r or w is 0 or 2^251 and up."""
    r = ec_mul(k, GENERATOR)[0]
    if not 0 < r < (1 << 251):
        return None
    denom = (message + r * privkey) % FR
    if denom == 0:
        return None
    w = k * pow(denom, -1, FR) % FR
    if not 0 < w < (1 << 251):
        return None
    return r, w


def _verify(msg_hash: int, r: int, w: int, pubkey_x: int) -> bool:
    """The AIR's formula: x(w (z G + r Q) - shift) == r for one of the two
    public keys of pubkey_x."""
    y = recover_y(pubkey_x)
    if y is None:
        return False
    for pubkey_y in (y, (-y) % P):
        zg = _ecdsa_mimic(msg_hash, GENERATOR, ec_neg(SHIFT_POINT))
        rq = _ecdsa_mimic(r, (pubkey_x, pubkey_y), SHIFT_POINT) \
            if zg is not None else None
        wb = _ecdsa_mimic(w, ec_add(zg, rq), SHIFT_POINT) \
            if rq is not None else None
        if wb is not None and r == ec_add(wb, ec_neg(SHIFT_POINT))[0]:
            return True
    return False


def signatures(rng, count: int):
    """ECDSA instances {"index", "pubkey", "msg", "signature_input": {"r",
    "w"}} signed by one private key drawn from rng."""
    priv = draw(rng, FR - 1) + 1
    pub_x = ec_mul(priv, GENERATOR)[0]
    out = []
    while len(out) < count:
        msg = draw(rng, 1 << 251)
        sig = _sign(priv, msg, draw(rng, FR - 1) + 1)
        if msg == 0 or sig is None or not _verify(msg, *sig, pub_x):
            continue
        out.append({"index": len(out), "pubkey": hex(pub_x), "msg": hex(msg),
                    "signature_input": {"r": hex(sig[0]), "w": hex(sig[1])}})
    return out


def ec_ops(rng, count: int):
    """EC-op instances {"index", "p_x", "p_y", "q_x", "q_y", "m"}: p and q
    multiples of the generator, m below 2^251."""
    out = []
    while len(out) < count:
        p = ec_mul(draw(rng, FR - 1) + 1, GENERATOR)
        q = ec_mul(draw(rng, FR - 1) + 1, GENERATOR)
        m = draw(rng, 1 << 251)
        if _ec_op_mimic(m, q, p) is None:
            continue
        out.append({"index": len(out), "p_x": hex(p[0]), "p_y": hex(p[1]),
                    "q_x": hex(q[0]), "q_y": hex(q[1]), "m": hex(m)})
    return out

