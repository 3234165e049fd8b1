"""The ECDSA builtin: the signature-verification witness (copy of the
per-instance route of sandstorm_tpu/builtins/ecdsa.py).

The reference sandstorm's builtins/src/ecdsa/mod.rs: the public key
recovered from its x-coordinate, the 256-step EC multiply-add traces of
z G (the generator's doublings capped at 250), r Q and w B with
B = z G + r Q, the doubling steps, the scalar inverses, and
r = x(w B - shift); `mimic_ec_mad_air` fails exactly where the AIR would.
The dummy instance (private key 1) is memoized.

The trace builder takes the witness as limbs: witness_limbs runs the
native lockstep batch (native/ecdsa.cpp's ecdsa_witness_batch) and hands
its canonical u64 limbs over as step columns.  new_batch turns the same
limbs into InstanceTraces; `new` is the plain python version, which the
tests hold the batch to.
"""

import dataclasses
import functools

import numpy as np

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
        """items: (index, pubkey_x, message, r, w) tuples -> InstanceTraces
        through the native batch (witness_limbs)."""
        from ..layouts.utils import u64limbs_to_ints
        if not items:
            return []
        wl = witness_limbs(items)
        zg, rq_wb, dbl, s, pub_y, m_suf, rw_suf = (
            u64limbs_to_ints(v) for v in (
                wl.zg, wl.rq_wb, wl.doubling, wl.singles, wl.pubkey_y,
                wl.message_suffix, wl.rw_suffix))

        def mad_steps(block, suffix):
            return [EcMadPartialStep(
                partial_sum=(b[0], b[1]), fixed_point=(b[2], b[3]),
                suffix=sf, slope=b[4], x_diff_inv=b[5])
                for b, sf in zip(block, suffix)]

        def dbl_steps(block):
            return [DoublingStep(point=(b[0], b[1]), slope=b[2])
                    for b in block]

        return [cls(
            index=index, pubkey_x=x, message=m, r=r, w=w,
            pubkey=(x, pub_y[i]),
            pubkey_doubling_steps=dbl_steps(dbl[i, :256]),
            w_inv=s[i, 13], r_inv=s[i, 14],
            r_point_slope=s[i, 10], r_point_x_diff_inv=s[i, 11],
            message_inv=s[i, 15],
            b=(s[i, 4], s[i, 5]), b_slope=s[i, 6], b_x_diff_inv=s[i, 7],
            b_doubling_steps=dbl_steps(dbl[i, 256:]),
            zg_steps=mad_steps(zg[i], m_suf[i]),
            rq_steps=mad_steps(rq_wb[i, :256], rw_suf[i, :256]),
            wb_steps=mad_steps(rq_wb[i, 256:], rw_suf[i, 256:]),
        ) for i, (index, x, m, r, w) in enumerate(items)]


# the native batch's 16 single felts an instance, in its order (ecdsa.cpp)
SINGLES = ("zg_x", "zg_y", "rq_x", "rq_y", "b_x", "b_y", "b_slope",
           "b_x_diff_inv", "wb_x", "wb_y", "r_point_slope",
           "r_point_x_diff_inv", "r_out", "w_inv", "r_inv", "message_inv")


@dataclasses.dataclass
class WitnessLimbs:
    """The witness of k signatures as canonical LE u64 limbs: views of the
    native batch's output.  A multiply-add step holds (partial x, partial
    y, addend x, addend y, slope, x-diff inverse), a doubling step (x, y,
    slope)."""
    index: np.ndarray           # [k] int64
    pubkey_x: np.ndarray        # [k, 4]
    pubkey_y: np.ndarray        # [k, 4]: the y that verifies
    message: np.ndarray         # [k, 4]
    zg: np.ndarray              # [k, 256, 6, 4]: z G's steps
    rq_wb: np.ndarray           # [k, 512, 6, 4]: r Q's, then w B's
    doubling: np.ndarray        # [k, 512, 3, 4]: the pubkey's, then B's
    singles: np.ndarray         # [k, 16, 4], named by SINGLES
    message_suffix: np.ndarray  # [k, 256, 4]: message >> step
    rw_suffix: np.ndarray       # [k, 512, 4]: r >> step, then w >> step
    pubkey_x_squared: np.ndarray  # [k, 4]

    def single(self, name: str) -> np.ndarray:
        return self.singles[:, SINGLES.index(name)]


def witness_limbs(items) -> WitnessLimbs:
    """items: (index, pubkey_x, message, r, w) tuples -> their witness
    through the native lockstep batch, checked as `new` checks it: an
    invalid signature raises.  The public key's y is recover_y's; an
    instance that fails with it (a failed chain or an r mismatch) goes
    again with the mirrored y, as verify tries both."""
    from .. import native
    from ..layouts.utils import ints_to_u64limbs, u64limbs_shr
    pubx, msg, rr, ww = ([it[j] for it in items] for j in (1, 2, 3, 4))
    for v in msg + rr + ww:
        assert 0 < v < (1 << 251), "signature is invalid"
    ys = []
    for x in pubx:
        y = recover_y(x)
        if y is None:
            raise ValueError("pubkey_x not on the curve")
        ys.append(y)
    m_l, r_l, w_l, x_l = (ints_to_u64limbs(v) for v in (msg, rr, ww, pubx))
    out, status = native.ecdsa_witness_batch(m_l, r_l, w_l, x_l,
                                             ints_to_u64limbs(ys))
    retry = np.nonzero(status)[0]
    if len(retry):
        for i in retry:
            ys[i] = (-ys[i]) % P
        out2, status2 = native.ecdsa_witness_batch(
            m_l[retry], r_l[retry], w_l[retry], x_l[retry],
            ints_to_u64limbs(ys[i] for i in retry))
        assert not status2.any(), "signature is invalid"
        out[retry] = out2
    mads = out[:, :4608].reshape(-1, 768, 6, 4)
    singles = out[:, 6144:]
    # witness generation asserts that the AIR will pass: each chain's last
    # partial sum is its result (the r extraction was checked natively)
    for step, first in ((255, 0), (511, 2), (767, 8)):
        assert np.array_equal(singles[:, first:first + 2],
                              mads[:, step, :2])
    shifts = np.arange(256)
    return WitnessLimbs(
        index=np.asarray([it[0] for it in items], dtype=np.int64),
        pubkey_x=x_l, pubkey_y=ints_to_u64limbs(ys), message=m_l,
        zg=mads[:, :256], rq_wb=mads[:, 256:],
        doubling=out[:, 4608:6144].reshape(-1, 512, 3, 4), singles=singles,
        message_suffix=u64limbs_shr(m_l, shifts),
        rw_suffix=np.concatenate([u64limbs_shr(r_l, shifts),
                                  u64limbs_shr(w_l, shifts)], axis=1),
        pubkey_x_squared=ints_to_u64limbs(x * x % P for x in pubx))


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
    return InstanceTrace.new_batch([(0, *gen_dummy_instance())])[0]


@functools.lru_cache(maxsize=1)
def dummy_limbs() -> WitnessLimbs:
    """The dummy signature's witness limbs (index 0)."""
    return witness_limbs([(0, *gen_dummy_instance())])
