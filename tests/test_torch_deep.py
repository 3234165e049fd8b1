"""The DEEP composition's plain versions against the JAX package's
_deep_compose, on seeded LDE columns at N = 2^10, on the CPU: the windowed
loop (stark/prover.py _deep_compose: what deep_compose runs for a CPU
tensor) and the shifted-denominator form of the kernel (_deep_shifted:
the host's prep, u = 1 / (x - z) and v = 1 / (x - z^m) gathered at
shifted rows), with the recursive (73 points) and starknet (192 points)
trace arguments, with negative offsets, and with offsets of a trace length
and more, whose shifted reads wrap around the domain's end; a point of 20
terms, which the kernel's form splits, against the windowed loop.

Inputs are made with numpy from a seed and handed to both packages through
sandstorm_tpu_torch.interop.  Tolerance 0: the arithmetic is exact.  The
kernel (csrc/deep.cu) lives only on the card: chip_smoke.py holds it to
_deep_compose's plain version at the recursive and starknet paths' shapes,
and tests/test_torch_cuda.py to both plain versions at small ones.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.fields.fp252 import Fp252 as JF
from sandstorm_tpu.stark import prover as jprover
from sandstorm_tpu_torch.air.expr import trace_arguments
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.interop import to_jax_digits
from sandstorm_tpu_torch.stark import prover

P = TF.MODULUS
CPU = torch.device("cpu")
N_TRACE, BLOWUP = 1 << 9, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ints(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % P
            for _ in range(count)]


def _targs(case):
    n = N_TRACE
    if case == "negative":
        return [(0, 0), (1, -1), (2, -3), (0, 1), (1, -7), (2, 2),
                (0, -n + 1)]
    if case == "wrapping":   # offsets of a trace length and beyond
        return [(0, n), (1, n + 5), (2, 2 * n - 1), (0, 3), (1, 0),
                (2, 3 * n + 2), (1, 4), (2, 4)]
    if case == "wide":   # a point of 20 terms, more than one redc takes
        return [(0, 1), (1, -2)] + [(c, 4) for c in range(20)]
    if case == "recursive":
        from sandstorm_tpu_torch.layouts.recursive.air import \
            RecursiveAirConfig as A
        n_air = 1 << 12
    else:
        from sandstorm_tpu_torch.layouts.starknet.air import \
            StarknetAirConfig as A
        n_air = 1 << 15
    return trace_arguments(A.constraints(n_air, P,
                                         TF.root_of_unity_int(n_air)))


def _args(case):
    """The port's arguments after dom for a case's trace arguments over
    seeded columns, and the same columns as python ints."""
    targs = _targs(case)
    rng = np.random.default_rng(40 + len(targs))
    n = N_TRACE
    N = n * BLOWUP
    ncols = 1 + max(c for c, _ in targs)
    cols = {c: _ints(rng, N) for c in range(ncols)}
    comp = [_ints(rng, N) for _ in range(2)]
    tvals, cvals = _ints(rng, len(targs)), _ints(rng, 2)
    z, alpha = _ints(rng, 2)
    g = TF.root_of_unity_int(n)
    args = (targs, {c: TF.encode_ints(v, CPU) for c, v in cols.items()},
            [TF.encode_ints(v, CPU) for v in comp], tvals, cvals, z, g, n,
            alpha)
    return args, (cols, comp)


@functools.lru_cache(maxsize=None)
def _case(case):
    """(the port's arguments after dom, the JAX package's _deep_compose as
    digits) for a case."""
    args, (cols, comp) = _args(case)
    targs, _, _, tvals, cvals, z, g, n, alpha = args
    jdom = jprover._DomainCache(JF, N_TRACE * BLOWUP, JF.GENERATOR)
    want = jprover._deep_compose(
        JF, jdom, targs, {c: JF.encode_ints(v) for c, v in cols.items()},
        [JF.encode_ints(v) for v in comp], tvals, cvals, z, g, n, alpha)
    return args, np.asarray(jnp.asarray(want))


def _dom():
    return prover._DomainCache(TF, N_TRACE * BLOWUP, TF.GENERATOR, CPU)


@pytest.mark.parametrize("layout", ["recursive", "starknet"])
def test_plain_deep_matches_jax(layout):
    args, want = _case(layout)
    got = prover.deep_compose(TF, _dom(), *args)
    assert prover.LAST_CHUNKS["DEEP composition"] == 1
    K = 73 if layout == "recursive" else 192
    assert len({off for _, off in args[0]}) + 1 == K
    assert got.shape == (N_TRACE * BLOWUP, 8)
    assert np.array_equal(to_jax_digits(got), want)


@pytest.mark.parametrize("case", ["recursive", "starknet", "negative",
                                  "wrapping"])
def test_shifted_deep_matches_jax(case):
    """The kernel's form in plain ops (_deep_shifted) equals the JAX
    package's _deep_compose."""
    args, want = _case(case)
    got = prover._deep_shifted(TF, _dom(), *args)
    assert np.array_equal(to_jax_digits(got), want)


def test_shifted_deep_splits_a_wide_point():
    """A point of 20 terms (split 16 + 4: one redc of the kernel takes 16
    products) gives the windowed loop's values, which the tests above hold
    to the JAX package.  (The JAX package's fused dispatch of a 20-term
    point takes XLA:CPU minutes to compile.)"""
    args, _ = _args("wide")
    assert torch.equal(prover._deep_shifted(TF, _dom(), *args),
                       prover._deep_compose(TF, _dom(), *args))


def test_shifted_terms_fold_the_shift_into_the_coefficients():
    """_deep_shifted_terms on the wide case: a trace point's shift is
    (off mod n) * blowup and its coefficients are alpha^j g^-(off mod n),
    its constant sum_j a_j t_j; the composition point reads v at shift 0;
    the point of 20 terms is split 16 + 4 with one shift; a trace
    generator that is not w^(N/n) is refused."""
    args, _ = _args("wide")
    targs, cols, comp, tv, cv, z, g, n, alpha = args
    points, (z0, zm) = prover._deep_shifted_terms(TF, _dom(), *args)
    assert (z0, zm) == (z % P, pow(z, 2, P))
    shifts = [sh for sh, tab, _, _ in points if tab == 0]
    assert shifts == [(-2 % n) * BLOWUP, 1 * BLOWUP, 4 * BLOWUP,
                      4 * BLOWUP]
    split = [p for p in points if p[0] == 4 * BLOWUP and p[1] == 0]
    assert [len(p[2]) for p in split] == [16, 4]
    for shift, tab, terms, C in points:
        assert len(terms) <= prover.WIDE_TERMS
        o = shift // BLOWUP
        for lde, a in terms:
            j = next(j for j, (c, off) in enumerate(targs)
                     if cols[c] is lde and (off % n) * BLOWUP == shift) \
                if tab == 0 else len(targs) + [id(x) for x in comp].index(
                    id(lde))
            scale = pow(g, -o, P) if tab == 0 else 1
            assert a == pow(alpha, j, P) * scale % P
    comp_points = [p for p in points if p[1] == 1]
    assert len(comp_points) == 1 and comp_points[0][0] == 0
    assert comp_points[0][3] == sum(
        pow(alpha, len(targs) + l, P) * cv[l] for l in range(2)) % P
    with pytest.raises(ValueError, match="trace generator"):
        prover._deep_shifted_terms(TF, _dom(), targs, cols, comp, tv, cv, z,
                                   pow(g, 3, P), n, alpha)


def test_deep_shapes_refuse_32_bit_overflow():
    """check_deep_shapes (deep_compose's wrapper) takes starknet's 2^22
    rows of a 10-column stack and refuses a column whose last word's
    offset overflows 32 bits, a domain that is no power of two or of more
    than 2^29 rows, and a column on another device."""
    meta = torch.device("meta")

    def rows(n, stride):
        return torch.empty_strided((n, 8), (stride, 1), dtype=torch.int32,
                                   device=meta)

    N = 1 << 22
    prover.check_deep_shapes([rows(N, 80)] * 12, N, meta)
    with pytest.raises(ValueError, match="32-bit"):
        prover.check_deep_shapes([rows(N, 1 << 11)], N, meta)
    with pytest.raises(ValueError, match="power of two"):
        prover.check_deep_shapes([rows(3 << 20, 8)], 3 << 20, meta)
    prover.check_deep_shapes([rows(1 << 29, 8)], 1 << 29, meta)
    with pytest.raises(ValueError, match="power of two"):
        prover.check_deep_shapes([rows(1 << 30, 8)], 1 << 30, meta)
    with pytest.raises(ValueError, match="on the device"):
        prover.check_deep_shapes([rows(N, 8)], N, CPU)
