"""The ECDSA builtin: the signature-verification witness (copy of the
per-instance route of sandstorm_tpu/builtins/ecdsa.py).

The reference sandstorm's builtins/src/ecdsa/mod.rs: the public key
recovered from its x-coordinate, the 256-step EC multiply-add traces of
z G (the generator's doublings capped at 250), r Q and w B with
B = z G + r Q, the doubling steps, the scalar inverses, and
r = x(w B - shift); `mimic_ec_mad_air` fails exactly where the AIR would.
The dummy instance (private key 1) is memoized.  Every instance runs the
python route: the JAX package's native lockstep batch is not ported.
"""

import dataclasses
import functools

from . import pedersen
from .curve import (FR, GENERATOR, P, calculate_slope, ec_add, ec_double,
                    ec_mul, ec_neg, inv, recover_y)


def shift_point():
    return pedersen.shift_and_table_points()[0]


@dataclasses.dataclass
class EcMadPartialStep:
    partial_sum: tuple
    fixed_point: tuple
    suffix: int
    slope: int
    x_diff_inv: int


@dataclasses.dataclass
class DoublingStep:
    point: tuple
    slope: int


def doubling_steps(num_steps: int, p):
    out = []
    for _ in range(num_steps):
        out.append(DoublingStep(point=p, slope=calculate_slope(p, p)))
        p = ec_double(p)
    return out


def mimic_ec_mad_air(m: int, point, shift):
    """shift + m * point with the AIR's failure modes: None when a partial
    sum shares its x-coordinate with the addend, or when m has 0 or 252
    and more bits."""
    if not (1 <= m.bit_length() < 252):
        return None
    partial = shift
    while m:
        if partial[0] == point[0]:
            return None
        if m & 1:
            partial = ec_add(partial, point)
        point = ec_double(point)
        m >>= 1
    return partial


def gen_ec_mad_steps(x: int, point, shift, max_point_doublings: int = 255):
    """The 256 EC multiply-add partial steps of shift + x * point."""
    assert 0 < x < (1 << 251)
    partial = shift
    res = []
    for i in range(256):
        suffix = x >> i
        slope = 0
        nxt = partial
        if suffix & 1:
            slope = calculate_slope(point, partial)
            nxt = ec_add(partial, point)
        res.append(EcMadPartialStep(
            partial_sum=partial, fixed_point=point, suffix=suffix,
            slope=slope, x_diff_inv=inv(partial[0] - point[0])))
        partial = nxt
        if i < max_point_doublings:
            point = ec_double(point)
    return res


def verify(msg_hash: int, r: int, s_inv_w: int, pubkey_x: int):
    """Verify by the AIR's formula x(w (z G + r Q) - shift) == r, where
    s_inv_w is the signature's w = s^-1 (mod the curve order); returns the
    recovered public key or None."""
    w = s_inv_w
    y = recover_y(pubkey_x)
    if y is None:
        raise ValueError("pubkey_x not on the curve")
    shift = shift_point()
    for pubkey_y in (y, (-y) % P):
        pubkey = (pubkey_x, pubkey_y)
        zg = mimic_ec_mad_air(msg_hash, GENERATOR, ec_neg(shift))
        if zg is None:
            continue
        rq = mimic_ec_mad_air(r, pubkey, shift)
        if rq is None:
            continue
        wb = mimic_ec_mad_air(w, ec_add(zg, rq), shift)
        if wb is None:
            continue
        if r == ec_add(wb, ec_neg(shift))[0]:
            return pubkey
    return None


@dataclasses.dataclass
class InstanceTrace:
    index: int
    pubkey_x: int
    message: int
    r: int
    w: int
    pubkey: tuple
    pubkey_doubling_steps: list
    w_inv: int
    r_inv: int
    r_point_slope: int
    r_point_x_diff_inv: int
    message_inv: int
    b: tuple
    b_slope: int
    b_x_diff_inv: int
    b_doubling_steps: list
    zg_steps: list
    rq_steps: list
    wb_steps: list

    @classmethod
    def new(cls, index: int, pubkey_x: int, message: int, r: int, w: int):
        pubkey = verify(message, r, w, pubkey_x)
        assert pubkey is not None, "signature is invalid"
        shift = shift_point()
        neg_shift = ec_neg(shift)

        zg = mimic_ec_mad_air(message, GENERATOR, neg_shift)
        rq = mimic_ec_mad_air(r, pubkey, shift)
        b = ec_add(zg, rq)
        wb = mimic_ec_mad_air(w, b, shift)

        zg_steps = gen_ec_mad_steps(message, GENERATOR, neg_shift, 250)
        rq_steps = gen_ec_mad_steps(r, pubkey, shift, 255)
        wb_steps = gen_ec_mad_steps(w, b, shift, 255)
        # witness generation asserts that the AIR will pass
        assert zg == zg_steps[-1].partial_sum
        assert rq == rq_steps[-1].partial_sum
        assert wb == wb_steps[-1].partial_sum
        assert r == ec_add(wb, neg_shift)[0]

        return cls(
            index=index, pubkey_x=pubkey_x, message=message, r=r, w=w,
            pubkey=pubkey,
            pubkey_doubling_steps=doubling_steps(256, pubkey),
            w_inv=inv(w), r_inv=inv(r),
            r_point_slope=calculate_slope(wb, neg_shift),
            r_point_x_diff_inv=inv(wb[0] - neg_shift[0]),
            message_inv=inv(message),
            b=b, b_slope=calculate_slope(zg, rq),
            b_x_diff_inv=inv(zg[0] - rq[0]),
            b_doubling_steps=doubling_steps(256, b),
            zg_steps=zg_steps, rq_steps=rq_steps, wb_steps=wb_steps,
        )

    @classmethod
    def new_dummy(cls, index: int):
        return dataclasses.replace(_dummy_template(), index=index)

    @classmethod
    def new_batch(cls, items):
        """items: (index, pubkey_x, message, r, w) tuples, one `new`
        each."""
        return [cls.new(*it) for it in items]


def sign(privkey: int, message: int, k: int):
    """(r, w) of StarkWare's ECDSA for the nonce k: r = x(k G) and
    w = k / (message + r privkey) mod the curve order; None where r or w
    is 0 or 2^251 and up."""
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


def gen_dummy_instance():
    """The dummy signature: private key 1, the message pedersen(1, 0), the
    first nonce k = 1, 2, ... that signs it."""
    privkey = 1
    message = pedersen.pedersen_hash(1, 0)
    assert 0 < message < (1 << 251)
    k = 1
    while (sig := sign(privkey, message, k)) is None:
        k += 1
    r, w = sig
    return ec_mul(privkey, GENERATOR)[0], message, r, w


@functools.lru_cache(maxsize=1)
def _dummy_template():
    pubkey_x, message, r, w = gen_dummy_instance()
    return InstanceTrace.new(0, pubkey_x, message, r, w)
