"""Frozen copy of sandstorm_tpu_torch/builtins/curve.py: the Starkware curve
y^2 = x^3 + alpha*x + beta over the 252-bit field, affine python-int
points (None is the point at infinity)."""

P = (1 << 251) + 17 * (1 << 192) + 1
ALPHA = 1
BETA = 3141592653589793238462643383279502884197169399375105820974944592307816406665
# the scalar field (the group order)
FR = 3618502788666131213697322783095070105526743751716087489154079457884512865583

# the ECDSA generator (StarkWare's signature parameters)
GENERATOR = (
    874739451078007766457464989774322083649278607533249481151382481072868806602,
    152666792071518830868575557812948353041420400780739481342941381225525861407,
)


def inv(x: int) -> int:
    """x^-1 mod P by extended Euclid, and 0 for 0: the value of the Fermat
    power x^(P-2) the JAX package takes, far faster."""
    x %= P
    return pow(x, -1, P) if x else 0


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + ALPHA * x + BETA)) % P == 0


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


def ec_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def sqrt_mod_p(a: int):
    """Tonelli-Shanks square root mod P (two-adicity 192), or None."""
    if a == 0:
        return 0
    if pow(a, (P - 1) // 2, P) != 1:
        return None
    # P - 1 = q * 2^s with q odd
    q, s = P - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 3  # a non-residue (the field's multiplicative generator)
    m, c, t, r = s, pow(z, q, P), pow(a, q, P), pow(a, (q + 1) // 2, P)
    while t != 1:
        t2 = t
        i = 0
        while t2 != 1:
            t2 = t2 * t2 % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m, c = i, b * b % P
        t = t * c % P
        r = r * b % P
    return r


def recover_y(x: int):
    """A y with y^2 = x^3 + alpha x + beta, or None if x is not on the
    curve; the caller tries both signs (ECDSA's public-key recovery)."""
    return sqrt_mod_p((x * x * x + ALPHA * x + BETA) % P)
