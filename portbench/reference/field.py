"""The 252-bit Starkware field as python ints (the host half of the port's
fields/fp252.py)."""

P = (1 << 251) + 17 * (1 << 192) + 1


class Fp252:
    MODULUS = P
    BASE_MODULUS = P
    TWO_ADICITY = 192
    GENERATOR = 3

    @staticmethod
    def s(v):
        return int(v) % P

    @classmethod
    def root_of_unity_int(cls, order: int) -> int:
        if order & (order - 1) or order > (1 << cls.TWO_ADICITY):
            raise ValueError(f"no root of unity of order {order}")
        return pow(cls.GENERATOR, (P - 1) // order, P)


def batch_inv(vals):
    """Montgomery-trick inversion mod P; 0 -> 0."""
    pref, acc = [], 1
    for v in vals:
        pref.append(acc)
        if v:
            acc = acc * v % P
    inv = pow(acc, -1, P)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        if vals[i]:
            out[i] = pref[i] * inv % P
            inv = inv * vals[i] % P
    return out
