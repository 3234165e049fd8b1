"""The StarkWare Pedersen hash and the Pedersen builtin's witness (copy of
sandstorm_tpu/builtins/pedersen.py).

hash(a, b) = x-coordinate of P0 + a_low*P1 + a_high*P2 + b_low*P3 +
b_high*P4, with low = the 248 low bits and high = the 4 bits above them.
P0..P4 are the "P" entry of sandstorm_tpu/builtins/data/pedersen_points.json
(StarkWare's parameters, derived from the digits of pi).

InstanceTrace: for each input, 256 ElementPartialStep{point, suffix, slope}
where step i holds the partial sum BEFORE consuming bit i, suffix = x >> i,
and slope = the addition slope when bit i is set (else 0); plus the
bit-251/196/192 product flags of the AIR's unique-unpacking constraints.
periodic_table_points gives the doubling chains the recursive layout's
periodic columns interpolate.

The trace builders take the witness as limbs: witness_limbs runs the
native lockstep batch (native/ecdsa.cpp's pedersen_witness_batch) and
hands its canonical u64 limbs over as [k, 512, 4] columns.  new_batch
turns the same limbs into InstanceTraces; `new` is the plain python
version, which the tests hold the batch to.
"""

import dataclasses
import functools

import numpy as np

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
N_ELEMENT_STEPS = 256


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


@dataclasses.dataclass
class ElementPartialStep:
    point: tuple   # partial sum (affine) before consuming bit i
    suffix: int    # x >> i
    slope: int     # addition slope when bit i is set, else 0


def gen_element_steps(x: int, start, which: int):
    """The 256 partial steps of one element."""
    chain = _chain(which)
    partial = start
    steps = []
    for i in range(N_ELEMENT_STEPS):
        suffix = x >> i
        bit = suffix & 1
        slope = 0
        nxt = partial
        if bit:
            slope = curve.calculate_slope(chain[i], partial)
            nxt = curve.ec_add(partial, chain[i])
        steps.append(ElementPartialStep(point=partial, suffix=suffix,
                                        slope=slope))
        partial = nxt
    return steps


def _bits(x):
    return (x >> 251) & 1, (x >> 196) & 1, (x >> 192) & 1


@dataclasses.dataclass
class InstanceTrace:
    """Witness for one pedersen builtin instance (a, b)."""
    index: int
    a: int
    b: int
    output: int
    a_steps: list
    b_steps: list
    a_bit251_and_bit196_and_bit192: bool
    a_bit251_and_bit196: bool
    b_bit251_and_bit196_and_bit192: bool
    b_bit251_and_bit196: bool

    @classmethod
    def new(cls, index: int, a: int, b: int) -> "InstanceTrace":
        a_steps = gen_element_steps(a, P0, 0)
        b_start = process_element(a, 0, P0)
        assert a_steps[-1].point == b_start or a >> 255 == 0
        b_steps = gen_element_steps(b, b_start, 1)
        output = pedersen_hash(a, b)
        # witness generation asserts that the AIR will pass
        assert b_steps[-1].point[0] == output if (b >> 255) == 0 else True
        a251, a196, a192 = _bits(a)
        b251, b196, b192 = _bits(b)
        return cls(
            index=index, a=a, b=b, output=output,
            a_steps=a_steps, b_steps=b_steps,
            a_bit251_and_bit196_and_bit192=bool(a251 and a196 and a192),
            a_bit251_and_bit196=bool(a251 and a196),
            b_bit251_and_bit196_and_bit192=bool(b251 and b196 and b192),
            b_bit251_and_bit196=bool(b251 and b196),
        )

    @classmethod
    def new_dummy(cls, index: int) -> "InstanceTrace":
        return dummy_instance_trace(index)

    @classmethod
    def new_batch(cls, items):
        """items: list of (index, a, b) -> InstanceTraces through the
        native batch (witness_limbs)."""
        from ..layouts.utils import u64limbs_to_ints
        if not items:
            return []
        wl = witness_limbs(items)
        px, py, slope, suffix, output = (u64limbs_to_ints(v) for v in (
            wl.point_x, wl.point_y, wl.slope, wl.suffix, wl.output))
        traces = []
        for i, (index, a, b) in enumerate(items):
            steps = [ElementPartialStep(point=(px[i, s], py[i, s]),
                                        suffix=suffix[i, s], slope=slope[i, s])
                     for s in range(2 * N_ELEMENT_STEPS)]
            traces.append(cls(
                index=index, a=a, b=b, output=output[i],
                a_steps=steps[:N_ELEMENT_STEPS],
                b_steps=steps[N_ELEMENT_STEPS:],
                a_bit251_and_bit196_and_bit192=bool(wl.bit251_196_192[i, 0]),
                a_bit251_and_bit196=bool(wl.bit251_196[i, 0]),
                b_bit251_and_bit196_and_bit192=bool(wl.bit251_196_192[i, 1]),
                b_bit251_and_bit196=bool(wl.bit251_196[i, 1]),
            ))
        return traces


@dataclasses.dataclass
class WitnessLimbs:
    """The witness of k instances as canonical LE u64 limbs.  The step
    columns run over a's 256 steps, then b's: views of the native batch's
    output."""
    index: np.ndarray            # [k] int64
    a: np.ndarray                # [k, 4]
    b: np.ndarray                # [k, 4]
    output: np.ndarray           # [k, 4]: the hash
    point_x: np.ndarray          # [k, 512, 4]: the partial sum before a step
    point_y: np.ndarray          # [k, 512, 4]
    slope: np.ndarray            # [k, 512, 4]
    suffix: np.ndarray           # [k, 512, 4]: a >> step, then b >> step
    bit251_196_192: np.ndarray   # [k, 2] bool: (a, b)
    bit251_196: np.ndarray       # [k, 2] bool


def witness_limbs(items) -> WitnessLimbs:
    """items: (index, a, b) tuples -> their witness through the native
    lockstep batch, checked as `new` checks it: an input the AIR would
    refuse raises."""
    from .. import native
    from ..layouts.utils import ints_to_u64limbs, u64limbs_bit, u64limbs_shr
    a = ints_to_u64limbs(it[1] for it in items)
    b = ints_to_u64limbs(it[2] for it in items)
    out, status = native.pedersen_witness_batch(a, b)
    assert not status.any(), "pedersen input would fail in the AIR"
    steps = out[:, :1536].reshape(-1, 2 * N_ELEMENT_STEPS, 3, 4)
    # witness generation asserts that the AIR will pass: the output is the
    # x of the last b step's partial sum (bit 255 of a felt is never set)
    assert np.array_equal(out[:, 1536], steps[:, -1, 0])
    shifts = np.arange(N_ELEMENT_STEPS)
    flags = [[u64limbs_bit(x, bit) for bit in (251, 196, 192)]
             for x in (a, b)]
    return WitnessLimbs(
        index=np.asarray([it[0] for it in items], dtype=np.int64),
        a=a, b=b, output=out[:, 1536],
        point_x=steps[:, :, 0], point_y=steps[:, :, 1], slope=steps[:, :, 2],
        suffix=np.concatenate([u64limbs_shr(a, shifts),
                               u64limbs_shr(b, shifts)], axis=1),
        bit251_196_192=np.stack([f[0] & f[1] & f[2] for f in flags], 1),
        bit251_196=np.stack([f[0] & f[1] for f in flags], 1))


@functools.lru_cache(maxsize=1)
def _dummy_template():
    return InstanceTrace.new_batch([(0, 0, 0)])[0]


@functools.lru_cache(maxsize=1)
def dummy_limbs() -> WitnessLimbs:
    """The padding instance's witness limbs (a = b = 0, index 0)."""
    return witness_limbs([(0, 0, 0)])


def dummy_instance_trace(index: int) -> InstanceTrace:
    """Padding instance (a = b = 0), memoized."""
    return dataclasses.replace(_dummy_template(), index=index)


@functools.lru_cache(maxsize=4)
def periodic_table_points(which: int):
    """The doubling-chain coordinates the periodic columns interpolate: 256
    rows per input, the 248 doublings of its low point, the 4 of its high
    point, then the last point repeated (the AIR constrains only the first
    252 of each half-instance)."""
    chain = _chain(which)
    return list(chain) + [chain[-1]] * (256 - len(chain))
