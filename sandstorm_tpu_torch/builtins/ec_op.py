"""The EC-op builtin: the witness of r = p + m q (copy of the per-instance
route of sandstorm_tpu/builtins/ec_op.py).

The reference sandstorm's builtins/src/ec_op/mod.rs: 256 doubling steps of
q, 256 multiply-add partial steps and the flags of m's bits 251, 196 and
192.  The dummy instance (p the shift point, q the generator, m = 1) is
memoized.

The trace builder takes the witness as limbs: witness_limbs runs the
native lockstep batch (native/ecdsa.cpp's ec_op_witness_batch) and hands
its canonical u64 limbs over as step columns.  new_batch turns the same
limbs into InstanceTraces; `new` is the plain python version, which the
tests hold the batch to.
"""

import dataclasses
import functools

import numpy as np

from . import pedersen
from .curve import (GENERATOR, calculate_slope, ec_add, ec_double, inv,
                    is_on_curve)
from .ecdsa import DoublingStep, EcMadPartialStep, doubling_steps


def mimic_ec_mad_air(m: int, q, p):
    """p + m q with the AIR's failure modes: None when a partial sum shares
    its x-coordinate with the addend.  Unlike ECDSA's it takes any m in
    [0, 2^252)."""
    partial = p
    while m:
        if partial[0] == q[0]:
            return None
        if m & 1:
            partial = ec_add(partial, q)
        q = ec_double(q)
        m >>= 1
    return partial


def gen_ec_mad_steps(m: int, q, p):
    partial = p
    res = []
    for i in range(256):
        suffix = m >> i
        slope = 0
        nxt = partial
        if suffix & 1:
            slope = calculate_slope(q, partial)
            nxt = ec_add(partial, q)
        res.append(EcMadPartialStep(
            partial_sum=partial, fixed_point=q, suffix=suffix, slope=slope,
            x_diff_inv=inv(partial[0] - q[0])))
        partial = nxt
        q = ec_double(q)
    return res


@dataclasses.dataclass
class InstanceTrace:
    index: int
    p: tuple
    q: tuple
    m: int
    r: tuple
    q_doubling_steps: list
    r_steps: list
    m_bit251_and_bit196_and_bit192: bool
    m_bit251_and_bit196: bool

    @classmethod
    def new(cls, index: int, p_x: int, p_y: int, q_x: int, q_y: int, m: int):
        p, q = (p_x, p_y), (q_x, q_y)
        assert is_on_curve(p) and is_on_curve(q)
        r = mimic_ec_mad_air(m, q, p)
        assert r is not None, "EC op would fail in the AIR"
        r_steps = gen_ec_mad_steps(m, q, p)
        assert r == r_steps[-1].partial_sum
        b251, b196, b192 = (m >> 251) & 1, (m >> 196) & 1, (m >> 192) & 1
        return cls(
            index=index, p=p, q=q, m=m, r=r,
            q_doubling_steps=doubling_steps(256, q), r_steps=r_steps,
            m_bit251_and_bit196_and_bit192=bool(b251 and b196 and b192),
            m_bit251_and_bit196=bool(b251 and b196),
        )

    @classmethod
    def new_dummy(cls, index: int):
        return dataclasses.replace(_dummy_template(), index=index)

    @classmethod
    def new_batch(cls, items):
        """items: (index, p_x, p_y, q_x, q_y, m) tuples -> InstanceTraces
        through the native batch (witness_limbs)."""
        from ..layouts.utils import u64limbs_to_ints
        if not items:
            return []
        wl = witness_limbs(items)
        mads, dbls, r, suffix = (u64limbs_to_ints(v) for v in (
            wl.r_steps, wl.q_doubling, wl.r, wl.m_suffix))
        return [cls(
            index=index, p=(p_x, p_y), q=(q_x, q_y), m=m,
            r=(r[i, 0], r[i, 1]),
            q_doubling_steps=[DoublingStep(point=(b[0], b[1]), slope=b[2])
                              for b in dbls[i]],
            r_steps=[EcMadPartialStep(
                partial_sum=(b[0], b[1]), fixed_point=(b[2], b[3]),
                suffix=sf, slope=b[4], x_diff_inv=b[5])
                for b, sf in zip(mads[i], suffix[i])],
            m_bit251_and_bit196_and_bit192=bool(wl.bit251_196_192[i]),
            m_bit251_and_bit196=bool(wl.bit251_196[i]),
        ) for i, (index, p_x, p_y, q_x, q_y, m) in enumerate(items)]


@dataclasses.dataclass
class WitnessLimbs:
    """The witness of k EC ops as canonical LE u64 limbs: views of the
    native batch's output.  A multiply-add step holds (partial x, partial
    y, addend x, addend y, slope, x-diff inverse), a doubling step (x, y,
    slope)."""
    index: np.ndarray            # [k] int64
    inputs: np.ndarray           # [k, 5, 4]: p_x, p_y, q_x, q_y, m
    r: np.ndarray                # [k, 2, 4]: r_x, r_y
    r_steps: np.ndarray          # [k, 256, 6, 4]
    q_doubling: np.ndarray       # [k, 256, 3, 4]
    m_suffix: np.ndarray         # [k, 256, 4]: m >> step
    bit251_196_192: np.ndarray   # [k] bool
    bit251_196: np.ndarray       # [k] bool


def witness_limbs(items) -> WitnessLimbs:
    """items: (index, p_x, p_y, q_x, q_y, m) tuples -> their witness
    through the native lockstep batch, checked as `new` checks it: points
    off the curve, and an op the AIR would refuse, raise."""
    from .. import native
    from ..layouts.utils import ints_to_u64limbs, u64limbs_bit, u64limbs_shr
    for _, p_x, p_y, q_x, q_y, _m in items:
        assert is_on_curve((p_x, p_y)) and is_on_curve((q_x, q_y))
    inputs = ints_to_u64limbs(v for it in items for v in it[1:]).reshape(
        -1, 5, 4)
    out, status = native.ec_op_witness_batch(
        *[inputs[:, j] for j in range(5)])
    assert not status.any(), "EC op would fail in the AIR"
    r_steps = out[:, :1536].reshape(-1, 256, 6, 4)
    # witness generation asserts that the AIR will pass: r is the last
    # step's partial sum
    assert np.array_equal(out[:, 2304:], r_steps[:, -1, :2])
    m = inputs[:, 4]
    b251, b196, b192 = (u64limbs_bit(m, bit) for bit in (251, 196, 192))
    return WitnessLimbs(
        index=np.asarray([it[0] for it in items], dtype=np.int64),
        inputs=inputs, r=out[:, 2304:], r_steps=r_steps,
        q_doubling=out[:, 1536:2304].reshape(-1, 256, 3, 4),
        m_suffix=u64limbs_shr(m, np.arange(256)),
        bit251_196_192=b251 & b196 & b192, bit251_196=b251 & b196)


def _dummy_item():
    p0 = pedersen.shift_and_table_points()[0]
    return (0, p0[0], p0[1], GENERATOR[0], GENERATOR[1], 1)


@functools.lru_cache(maxsize=1)
def _dummy_template():
    return InstanceTrace.new_batch([_dummy_item()])[0]


@functools.lru_cache(maxsize=1)
def dummy_limbs() -> WitnessLimbs:
    """The dummy instance's witness limbs (index 0)."""
    return witness_limbs([_dummy_item()])
