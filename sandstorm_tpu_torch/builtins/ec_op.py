"""The EC-op builtin: the witness of r = p + m q (copy of the per-instance
route of sandstorm_tpu/builtins/ec_op.py).

The reference sandstorm's builtins/src/ec_op/mod.rs: 256 doubling steps of
q, 256 multiply-add partial steps and the flags of m's bits 251, 196 and
192.  The dummy instance (p the shift point, q the generator, m = 1) is
memoized.  Every instance runs the python route: the JAX package's native
lockstep batch is not ported.
"""

import dataclasses
import functools

from . import pedersen
from .curve import (GENERATOR, calculate_slope, ec_add, ec_double, inv,
                    is_on_curve)
from .ecdsa import EcMadPartialStep, doubling_steps


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
        """items: (index, p_x, p_y, q_x, q_y, m) tuples, one `new` each."""
        return [cls.new(*it) for it in items]


@functools.lru_cache(maxsize=1)
def _dummy_template():
    p0 = pedersen.shift_and_table_points()[0]
    return InstanceTrace.new(0, p0[0], p0[1], GENERATOR[0], GENERATOR[1], 1)
