"""Shared layout helpers (port of sandstorm_tpu/layouts/utils.py):
public-memory quotient, diluted-check math, pools, dilution, periodic
columns and the base-column upload.  Verifier-side scalars are python ints,
prover-side pools numpy arrays."""

import functools

import numpy as np


# -- verifier-side scalar helpers ---------------------------------------------

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


# builtin instances a native witness batch call: 1024 Pedersen instances
# are 50 MB of the batch's output
WITNESS_CHUNK = 1024


def witness_chunks(items):
    """A builtin's instances in chunks of WITNESS_CHUNK, one native batch
    call each, so that a batch's output is freed before the next."""
    for lo in range(0, len(items), WITNESS_CHUNK):
        yield items[lo:lo + WITNESS_CHUNK]


# -- pools ----------------------------------------------------------------------

def ints_to_u64limbs(vals):
    """Iterable of python ints < 2^256 -> [n, 4] uint64 little-endian
    words (one bytes join, not a python loop over limbs)."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u8").reshape(-1, 4).astype(np.uint64)


def u64limbs_to_ints(limbs):
    """[..., 4] little-endian u64 limbs -> object ndarray of python ints."""
    o = np.asarray(limbs, dtype=np.uint64).astype(object)
    return (o[..., 0] + (o[..., 1] << 64) + (o[..., 2] << 128)
            + (o[..., 3] << 192))


def u64limbs_shr(limbs, shifts):
    """x >> s for each row x of [k, 4] LE u64 limbs and each s of `shifts`
    (0..255): [k, len(shifts), 4] limbs.  Word j of x >> s is word j + q
    of x shifted right by r, with word j + q + 1 shifted left by 64 - r
    (s = 64 q + r).  numpy leaves a shift by 64 undefined (x86 takes it mod
    64), so the left shift is taken as (w << 1) << (63 - r): 0 at r = 0."""
    limbs = np.asarray(limbs, dtype=np.uint64)
    s = np.asarray(shifts, dtype=np.int64)
    r = (s % 64).astype(np.uint64)[:, None]
    src = (s // 64)[:, None] + np.arange(4)[None, :]       # [S, 4], <= 6
    words = np.zeros((limbs.shape[0], 8), dtype=np.uint64)
    words[:, :4] = limbs
    lo = words[:, src] >> r
    hi = (words[:, src + 1] << np.uint64(1)) << (np.uint64(63) - r)
    return lo | hi


def u64limbs_bit(limbs, bit: int):
    """Bit `bit` of each row of [k, 4] LE u64 limbs, as a [k] bool array
    (bits 192 to 255 are all in word 3)."""
    word = np.asarray(limbs, dtype=np.uint64)[:, bit // 64]
    return ((word >> np.uint64(bit % 64)) & np.uint64(1)).astype(bool)


def parse_hex(v):
    """A private-input value: a hex string or an int."""
    if isinstance(v, str):
        return int(v, 16)
    return int(v)


def ordered_with_padding(values: np.ndarray, lo=None, hi=None):
    """Sort values and compute the gap-filling padding making them
    continuous over [lo, hi] (defaults: min/max of the values).

    Returns (ordered_incl_padding, padding), both ascending, in the dtype of
    `values`."""
    ordered = np.sort(values)
    lo = int(ordered[0]) if lo is None else int(lo)
    hi = int(ordered[-1]) if hi is None else int(hi)
    assert lo <= int(ordered[0]) and int(ordered[-1]) <= hi
    full = np.arange(lo, hi + 1, dtype=values.dtype)
    present = np.zeros(hi - lo + 1, dtype=bool)
    present[(ordered - lo).astype(np.int64)] = True
    padding = full[~present]
    merged = np.sort(np.concatenate([ordered, padding]))
    return merged, padding


# -- dilution -------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _dilute8_table(spacing: int):
    tbl = np.zeros(256, dtype=np.uint64)
    for v in range(256):
        out = 0
        for i in range(8):
            out |= ((v >> i) & 1) << (i * spacing)
        tbl[v] = out
    return tbl


def dilute_u16(values: np.ndarray, spacing: int = 4) -> np.ndarray:
    """Dilute uint16 values: bit i -> position i*spacing (fits in u64)."""
    tbl = _dilute8_table(spacing)
    v = values.astype(np.uint64)
    return tbl[(v & np.uint64(0xFF)).astype(np.int64)] | (
        tbl[(v >> np.uint64(8)).astype(np.int64)] << np.uint64(8 * spacing))


# -- periodic columns -------------------------------------------------------------

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

    def lde_fn(self, F, dom):
        """Callable returning the [N / e, L] values on the LDE domain.

        x -> x^e makes the column periodic over the LDE with period N / e =
        blowup * interval: P is evaluated once on that short coset domain
        (coset^e), on the domain's device."""
        col = self.column
        e = self.exponent

        def fn():
            from ..ntt import coset_eval_from_coeffs
            period = dom.N // e
            assert period >= len(col.coeffs)
            cs = F.encode_ints(col.coeffs, dom.device)
            return coset_eval_from_coeffs(F, cs, period,
                                          pow(dom.coset, e, F.MODULUS))

        return fn

    def eval_int(self, x: int, p: int) -> int:
        xe = pow(x, self.exponent, p)
        acc = 0
        for c in reversed(self.column.coeffs):
            acc = (acc * xe + c) % p
        return acc


def upload_base_columns(F, cols_dict, device):
    """Canonical base columns (dict idx -> numpy [n, 4] uint64 LE words) ->
    dict idx -> [n, L] tensors in F's encoding on `device`, in one upload."""
    keys = sorted(cols_dict)
    return dict(zip(keys, F.encode_canonical_u64_many(
        [cols_dict[i] for i in keys], device)))
