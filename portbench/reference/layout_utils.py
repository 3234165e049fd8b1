"""Frozen copy of the verifier-side helpers of sandstorm_tpu_torch/layouts/utils.py:
the public-memory quotient, the diluted-check terminal value and the
periodic columns, in python ints."""


def compute_public_memory_quotient(z, alpha, trace_len, public_memory,
                                   padding_entry, public_memory_step, p):
    """z^S / (prod_i (z - (a_i + alpha v_i)) * pad^(S - N))."""
    s = trace_len // public_memory_step
    numerator = pow(z, s, p)
    denominator = 1
    for e in public_memory:
        denominator = denominator * (z - (e.address + alpha * e.value)) % p
    padding = pow(z - (padding_entry.address + alpha * padding_entry.value) % p,
                  s - len(public_memory), p)
    return numerator * pow(denominator * padding % p, p - 2, p) % p


def compute_diluted_cumulative_value(z, alpha, n_bits, spacing, p):
    """Log-time recursion for the diluted-check aggregate's terminal value
    (the reference sandstorm's layouts/src/utils.rs:83-110)."""
    diff_multiplier = 1 << spacing
    diff_x = (1 << spacing) - 2
    p_acc = (z + 1) % p
    q_acc = 1
    x = 1
    for _ in range(1, n_bits):
        x = (x + diff_x) % p
        diff_x = diff_x * diff_multiplier % p
        xp = x * p_acc % p
        y = (p_acc + z * xp) % p
        q_acc = (q_acc + q_acc * y + x * xp) % p
        p_acc = p_acc * y % p
    return (p_acc + q_acc * alpha) % p


def intt_host(values, p, root):
    """Inverse NTT of python-int values over the given root's domain."""
    n = len(values)
    assert n & (n - 1) == 0
    inv_root = pow(root, -1, p)
    coeffs = _ntt_rec(list(values), p, inv_root)
    n_inv = pow(n, -1, p)
    return [c * n_inv % p for c in coeffs]


def _ntt_rec(a, p, w):
    n = len(a)
    if n == 1:
        return a
    even = _ntt_rec(a[0::2], p, w * w % p)
    odd = _ntt_rec(a[1::2], p, w * w % p)
    out = [0] * n
    x = 1
    for k in range(n // 2):
        t = x * odd[k] % p
        out[k] = (even[k] + t) % p
        out[k + n // 2] = (even[k] - t) % p
        x = x * w % p
    return out


class PeriodicColumn:
    """A column that repeats every `interval` trace rows.

    `coeffs` (python ints, power-of-two count) define the polynomial P over
    the len(coeffs)-th roots of unity; the column's value on trace row i is
    P(g^(i * n / interval)), i.e. entry (i % interval) / (interval /
    len(coeffs)) of the table P interpolates."""

    def __init__(self, coeffs, interval: int):
        self.coeffs = [int(c) for c in coeffs]
        self.interval = interval

    @classmethod
    def from_table(cls, table, interval: int, p: int, root):
        """Interpolate a value table over its canonical radix-2 domain."""
        return cls(intt_host(table, p, root), interval)

    def bind(self, trace_len: int):
        return BoundPeriodicColumn(self, trace_len)


class BoundPeriodicColumn:
    """A periodic column bound to a trace length (x -> x^(n / interval))."""

    def __init__(self, column: PeriodicColumn, trace_len: int):
        assert trace_len % column.interval == 0
        self.column = column
        self.exponent = trace_len // column.interval

    def eval_int(self, x: int, p: int) -> int:
        xe = pow(x, self.exponent, p)
        acc = 0
        for c in reversed(self.column.coeffs):
            acc = (acc * xe + c) % p
        return acc
