"""The port's running product and batch inversion (fields/scan.py, the plain
version of the fp252_scan_mul kernel on CPU tensors) against the JAX
package's prefix_mul / _prefix_mul_2level and Fp252.batch_inv, on the CPU.

Inputs are made with numpy from a seed and handed to both packages through
sandstorm_tpu_torch.interop.  Tolerance 0: the arithmetic is exact.  The
kernel itself is held to this plain version on the card by chip_smoke.py
(at 2^21 and 2^22 rows) and tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.fields.fp252 import Fp252 as JF
from sandstorm_tpu.fields.scan import _prefix_mul_2level
from sandstorm_tpu.fields.scan import prefix_mul as jax_prefix_mul
from sandstorm_tpu_torch.fields import fp252_cuda as fc
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.fields.scan import prefix_mul
from sandstorm_tpu_torch.interop import from_jax_digits, to_jax_digits

P = JF.MODULUS
SIZES = [1, 2, 3, 5, 64, 1000, 4096]


def _elements(seed, shape, zero_at=None):
    """Random field elements of `shape` (+ limbs) from a numpy seed, as a
    JAX digit array and a port tensor (the same Montgomery integers); with
    `zero_at`, that flat position holds 0."""
    rng = np.random.default_rng(seed)
    count = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(count)]
    if zero_at is not None:
        vals[zero_at] = 0
    digits = JF.encode_ints_np(vals).reshape(tuple(shape) + (16,))
    return jnp.asarray(digits), from_jax_digits(digits), vals


def _agree(jax_arr, port_t):
    return np.array_equal(np.asarray(jax_arr), to_jax_digits(port_t))


@pytest.mark.parametrize("width", [None, 3])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_prefix_mul_matches_jax(n, reverse, width):
    shape = (n,) if width is None else (n, width)
    ja, ta, vals = _elements(n * 7 + (width or 0) + reverse, shape)
    got = prefix_mul(TF, ta, reverse=reverse)
    assert got.shape == ta.shape
    assert _agree(jax_prefix_mul(JF, ja, reverse=reverse), got)
    assert torch.equal(got, fc.scan_mul(ta, reverse))
    if width is None and n & (n - 1) == 0 and n >= 64:
        # the JAX package's two-level scan (its route at n >= 2^10)
        assert _agree(_prefix_mul_2level(JF, ja, reverse), got)
    # python ints along one column
    col = vals[0::width or 1]
    want, acc = [], 1
    for v in (col[::-1] if reverse else col):
        acc = acc * v % P
        want.append(acc)
    flat = TF.decode_ints(got if width is None else got[:, 0])
    assert flat == (want[::-1] if reverse else want)


def test_scan_mul_writes_into_a_view():
    """scan_mul's `out` may be a view of a larger buffer, as batch_inv's
    exclusive forms use it."""
    _, ta, _ = _elements(3, (37, 2))
    buf = TF.zeros((38, 2), ta.device)
    fc.scan_mul(ta, False, out=buf[1:])
    assert torch.equal(buf[1:], prefix_mul(TF, ta))
    assert not buf[0].any()


@pytest.mark.parametrize("width", [None, 3])
@pytest.mark.parametrize("n", [1, 3, 64, 1000, 4096])
def test_batch_inv_matches_jax(n, width):
    shape = (n,) if width is None else (n, width)
    ja, ta, vals = _elements(n * 11 + (width or 0), shape)
    got = TF.batch_inv(ta)
    assert _agree(JF.batch_inv(ja), got)
    assert TF.decode_ints(got) == [pow(v, -1, P) for v in vals]


@pytest.mark.parametrize("shape,zero_at", [((64,), 17), ((1000, 3), 1500),
                                           ((5,), 0)])
def test_batch_inv_with_a_zero_gives_zeros(shape, zero_at):
    """A zero anywhere in a column makes every inverse of that column 0, as
    in the JAX package (the one inversion of the column's total gives
    inv(0) = 0); the other columns invert."""
    ja, ta, vals = _elements(len(shape) + zero_at, shape, zero_at)
    got = TF.batch_inv(ta)
    assert _agree(JF.batch_inv(ja), got)
    width = shape[1] if len(shape) > 1 else 1
    flat = TF.decode_ints(got)
    for i, v in enumerate(vals):
        zeroed = i % width == zero_at % width
        assert flat[i] == (0 if zeroed else pow(v, -1, P))
