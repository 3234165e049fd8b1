"""The port's running product and batch inversion (fields/scan.py, the plain
versions of the fp252_scan_mul and fp252_batch_inv kernels on CPU tensors)
against the JAX package's prefix_mul / _prefix_mul_2level and
Fp252.batch_inv, on the CPU; the kernels' run length and host trip.

Inputs are made with numpy from a seed and handed to both packages through
sandstorm_tpu_torch.interop.  Tolerance 0: the arithmetic is exact.  The
kernels themselves are held to these plain versions on the card by
chip_smoke.py (phase 3k) and tests/test_torch_cuda.py.
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
from sandstorm_tpu_torch.fields.scan import prefix_mul, prefix_scan
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
    assert torch.equal(got, prefix_scan(fc.mul_plain, ta, reverse))
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


@pytest.mark.parametrize("rows,sms,want", [
    (1, 132, 1), (1 << 14, 132, 1), ((1 << 18) + 5, 132, 2),
    (1 << 20, 132, 8), (1 << 21, 132, 16), (1 << 22, 132, 32),
    (1 << 23, 132, 32), (1 << 22, 114, 32), (25 * (1 << 15), 132, 8)])
def test_run_length_fills_the_card_then_caps(rows, sms, want):
    """A thread's run: the largest power of two that leaves two tiles an
    SM, 1 for a small call, at most SCAN_RUN_MAX; the grid then has at
    least two blocks an SM wherever the rows allow it."""
    run = fc.run_length(rows, sms)
    assert run == want and run & (run - 1) == 0
    assert run <= fc.SCAN_RUN_MAX
    tiles = -(-rows // (fc.SCAN_THREADS * run))
    assert tiles >= fc.SCAN_BLOCKS_PER_SM * sms or run == 1


def test_invert_totals_keeps_zero_and_stays_in_montgomery_form():
    """The host trip: each total's inverse in Montgomery form (R^2 / t), a
    zero total zero, no total folded with another."""
    vals = [0, 1, 5, P - 1, 0, 123456789 << 100]
    got = fc.invert_totals(TF.encode_ints(vals, torch.device("cpu")))
    assert TF.decode_ints(got) == [pow(v, -1, P) if v else 0 for v in vals]


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
