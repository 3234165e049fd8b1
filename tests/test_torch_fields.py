"""The port's Fp252 (sandstorm_tpu_torch/fields) against the JAX package's
Fp252 and python ints, on the CPU (plain versions of the kernels).

Inputs are made from a seed and handed to both packages through
sandstorm_tpu_torch.interop; every comparison is exact.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.fields.fp252 import Fp252 as JF
from sandstorm_tpu.fields.scan import prefix_mul as jax_prefix_mul
from sandstorm_tpu_torch import _native
from sandstorm_tpu_torch.fields import fp252_cuda as fc
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.fields.scan import prefix_mul
from sandstorm_tpu_torch.interop import from_jax_digits, to_jax_digits

P = JF.MODULUS
CPU = torch.device("cpu")


def _ints(seed, n):
    """n values: 0, 1, p-1 and neighbours of the limb boundaries, then
    random."""
    rng = random.Random(seed)
    special = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 64) - 1,
               (1 << 251) - 1]
    return (special + [rng.randrange(P) for _ in range(n)])[:n]


def _both(vals):
    """The same Montgomery elements as a JAX digit array and a port tensor."""
    digits = JF.encode_ints_np(vals)
    return jnp.asarray(digits), from_jax_digits(digits)


def _agree(jax_arr, port_t):
    return np.array_equal(np.asarray(jax_arr), to_jax_digits(port_t))


def test_encoding_matches_jax_digits_and_round_trips():
    vals = _ints(0, 70)
    t = torch.from_numpy(TF.encode_ints_np(vals).copy())
    assert torch.equal(t, from_jax_digits(JF.encode_ints_np(vals)))
    assert np.array_equal(to_jax_digits(t), JF.encode_ints_np(vals))
    assert TF.decode_ints(t) == vals
    assert TF.decode_ints(TF.encode_int(P - 1, CPU)) == [P - 1]


def test_encode_canonical_u64_matches_jax():
    vals = _ints(1, 40)
    u64 = np.array([[(v >> (64 * k)) & ((1 << 64) - 1) for k in range(4)]
                    for v in vals], dtype=np.uint64)
    got = TF.encode_canonical_u64_many([u64, u64[::-1]], CPU)
    want = JF.encode_canonical_u64_many([u64, u64[::-1]])
    for g, w in zip(got, want):
        assert _agree(w, g)
    assert TF.decode_ints(got[0]) == vals


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binop_matches_jax(op):
    xs, ys = _ints(2, 64), _ints(3, 64)[::-1]
    ja, ta = _both(xs)
    jb, tb = _both(ys)
    got = getattr(TF, op)(ta, tb)
    assert _agree(getattr(JF, op)(ja, jb), got)
    want = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
            "mul": lambda x, y: x * y % P}[op]
    assert TF.decode_ints(got) == [want(x, y) for x, y in zip(xs, ys)]


def test_neg_sqr_pow_static():
    xs = _ints(4, 33)
    ja, ta = _both(xs)
    assert _agree(JF.neg(ja), TF.neg(ta))
    assert TF.decode_ints(TF.sqr(ta)) == [x * x % P for x in xs]
    for e in (0, 1, 2, 3, 7, 65537):
        assert TF.decode_ints(TF.pow_static(ta, e)) == \
            [pow(x, e, P) for x in xs]


def test_inv_and_batch_inv_match_jax():
    xs = _ints(5, 48)
    ja, ta = _both(xs)
    assert _agree(JF.inv(ja), TF.inv(ta))            # inv(0) = 0 on both
    nz = [x for x in xs if x]
    jn, tn = _both(nz)
    got = TF.batch_inv(tn)
    assert _agree(JF.batch_inv(jn), got)
    assert TF.decode_ints(got) == [pow(x, -1, P) for x in nz]


@pytest.mark.parametrize("reverse", [False, True])
def test_prefix_mul_matches_jax(reverse):
    xs = _ints(6, 37)
    ja, ta = _both(xs)
    got = prefix_mul(TF, ta, reverse=reverse)
    assert _agree(jax_prefix_mul(JF, ja, reverse=reverse), got)
    # a batched [n, k, 8] scan runs along axis 0 only
    t2 = ta[:36].reshape(12, 3, 8)
    flat = TF.decode_ints(prefix_mul(TF, t2))
    for j in range(3):
        acc = 1
        for i in range(12):
            acc = acc * xs[3 * i + j] % P
            assert flat[3 * i + j] == acc


def test_to_bytes_words_matches_jax():
    xs = _ints(7, 20)
    ja, ta = _both(xs)
    words = TF.to_bytes_words(ta)
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(JF.to_bytes_words(ja)))
    assert words[4].numpy().view("<u4").tobytes() == xs[4].to_bytes(32,
                                                                   "little")


@pytest.mark.parametrize("a_shape,b_shape", [
    ((4, 6, 5), (4, 6, 5)), ((4, 6, 5), ()), ((4, 6, 5), (4, 6, 1)),
    ((4, 6, 5), (6, 1)), ((4, 6, 5), (5,)), ((4, 6, 5), (1, 1, 1)),
    ((4, 6, 5), (4, 1, 5)), ((6, 5), (3, 1, 1))])
def test_kernel_operand_index_rule(a_shape, b_shape):
    """The kernel reads operand element (i // div) % mod for output element
    i; the wrapper's (div, mod) must reproduce torch broadcasting (a copy
    is made when no such pair exists)."""
    shape = torch.broadcast_shapes(a_shape, b_shape)
    n = int(np.prod(shape))
    x = torch.arange(int(np.prod(b_shape)) * 8,
                     dtype=torch.int32).reshape(tuple(b_shape) + (8,))
    t, div, mod = fc._operand(x, shape)
    want = x.expand(tuple(shape) + (8,)).reshape(n, 8)
    idx = (torch.arange(n) // div) % mod
    assert torch.equal(t.reshape(-1, 8)[idx], want)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never builds or launches a kernel; a non-CPU tensor goes
    to the kernel wrapper, which raises rather than falling back."""
    _, ta = _both(_ints(8, 8))
    before = dict(_native.LAUNCHES)
    TF.mul(ta, ta)
    assert dict(_native.LAUNCHES) == before and _native._lib is None
    meta = torch.empty((8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fc.binop("mul", meta, meta)
    assert _native._lib is None
