"""The port's NTT (sandstorm_tpu_torch/ntt) against sandstorm_tpu.ntt, and
the plain leaf against the JAX package's Pallas leaf body
(ntt_pallas._mk_ntt_kernel run eagerly through mock refs, as
tests/test_ntt.py runs it), on the CPU."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.fields.fp252 import Fp252 as JF
from sandstorm_tpu.ntt import coset_eval_from_coeffs as jax_coset_eval
from sandstorm_tpu.ntt import ntt as jax_ntt
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.interop import from_jax_digits, to_jax_digits
from sandstorm_tpu_torch.ntt import (coset_eval_from_coeffs, intt, ntt,
                                     powers_dev)
from sandstorm_tpu_torch.ntt import ntt_cuda

P = JF.MODULUS
CPU = torch.device("cpu")


def _both(seed, n):
    rng = random.Random(seed)
    vals = ([0, 1, P - 1] + [rng.randrange(P) for _ in range(n)])[:n]
    digits = JF.encode_ints_np(vals)
    return vals, jnp.asarray(digits), from_jax_digits(digits)


def _agree(jax_arr, port_t):
    return np.array_equal(np.asarray(jax_arr), to_jax_digits(port_t))


@pytest.mark.parametrize("n", [16, 512])
def test_ntt_intt_match_jax(n):
    _, ja, ta = _both(n, n)
    assert _agree(jax_ntt(JF, ja), ntt(TF, ta))
    assert _agree(jax_ntt(JF, ja, inverse=True), intt(TF, ta))


@pytest.mark.parametrize("n", [16, 512])
def test_coset_eval_matches_jax(n):
    _, ja, ta = _both(n + 1, n)
    assert _agree(jax_coset_eval(JF, ja, 2 * n, JF.GENERATOR),
                  coset_eval_from_coeffs(TF, ta, 2 * n, TF.GENERATOR))


def test_fourstep_split_matches_single_leaf():
    """n = 512 at M_MAX = 256 takes one four-step level (two leaf passes, a
    twiddle multiply and a transpose); it must equal one 512-point leaf and
    the JAX transform, for a batch of 3 columns, both directions."""
    n = 512
    vals, ja, ta = _both(7, 3 * n)
    x = ta.reshape(n, 3, 8)
    for inverse in (False, True):
        split = ntt_cuda.batched_ntt(TF, x, inverse, m_max=256)
        whole = ntt_cuda.batched_ntt(TF, x, inverse, m_max=512)
        assert torch.equal(split, whole)
    cols = ntt(TF, x).unbind(1)
    for c in range(3):
        jcol = jnp.asarray(to_jax_digits(x[:, c].contiguous()))
        assert _agree(jax_ntt(JF, jcol), cols[c])


@pytest.mark.parametrize("R,C,B", [(16, 8, 3), (64, 4, 2)])
def test_fused_leaf_plain_is_leaf_twiddle_transpose(R, C, B):
    """The fused first leaf's plain twin (the CPU side of ntt_leaf_fused)
    equals ntt_leaf_plain, then the w^(k c) multiply, then the transpose
    to [C, R * B]; and a few outputs equal the python-int sum."""
    n = R * C
    vals, _, ta = _both(R + C + B, R * C * B)
    x = ta.reshape(R, C * B, 8)
    tw = ntt_cuda.stage_table(TF, R, False, CPU)
    rc = ntt_cuda._rc_twiddle(TF, n, R, False, CPU)
    got = ntt_cuda.ntt_leaf_fused(x, tw, rc, B)
    assert got.shape == (C, R * B, 8)
    leaf = ntt_cuda.ntt_leaf_plain(x, tw).reshape(R, C, B, 8)
    want = TF.mul(leaf, rc).transpose(0, 1).contiguous().reshape(C, R * B, 8)
    assert torch.equal(got, want)
    wR, wn = TF.root_of_unity_int(R), TF.root_of_unity_int(n)
    out = TF.decode_ints(got.reshape(-1, 8))
    for c, k, b in [(0, 0, 0), (1, 1, 0), (C - 1, R - 1, B - 1), (2, 5, 1)]:
        s = sum(vals[(r * C + c) * B + b] * pow(wR, r * k, P)
                for r in range(R)) * pow(wn, k * c, P) % P
        assert out[(c * R + k) * B + b] == s


@pytest.mark.parametrize("logn", [10, 11, 12])
def test_fourstep_through_fused_leaf_matches_jax(logn):
    """batched_ntt with a 32-point leaf cap (two or three four-step levels,
    each opening with the fused first leaf) equals one whole-length leaf
    and sandstorm_tpu.ntt's ntt / intt, for 2 columns."""
    n = 1 << logn
    _, _, ta = _both(logn, 2 * n)
    x = ta.reshape(n, 2, 8)
    for inverse in (False, True):
        split = ntt_cuda.batched_ntt(TF, x, inverse, m_max=32)
        assert torch.equal(split, ntt_cuda.batched_ntt(TF, x, inverse,
                                                       m_max=n))
        scale = TF.encode_int(pow(n, -1, P), CPU) if inverse else None
        for c in range(2):
            col = x[:, c].contiguous()
            port = TF.mul(split[:, c], scale) if inverse else split[:, c]
            jcol = jnp.asarray(to_jax_digits(col))
            assert _agree(jax_ntt(JF, jcol, inverse=inverse), port)


class _MockRef:
    """Eager stand-in for a Pallas VMEM ref (as in tests/test_ntt.py)."""

    def __init__(self, arr):
        self.arr = arr
        self.shape = arr.shape

    def __getitem__(self, k):
        return self.arr[k]

    def __setitem__(self, k, v):
        self.arr = self.arr.at[k].set(v)


def test_plain_leaf_matches_pallas_leaf_body():
    """The port's plain leaf (natural order in, bit-reversal inside) equals
    the TPU leaf kernel body on bit-reversed digit-major input."""
    from sandstorm_tpu.ntt import ntt_pallas as mod
    from sandstorm_tpu.ntt.ntt import bit_reverse_perm
    M, B = 16, mod.TB
    _, _, ta = _both(9, M * B)
    x = ta.reshape(M, B, 8)
    for inverse in (False, True):
        tw = ntt_cuda.stage_table(TF, M, inverse, CPU)
        got = ntt_cuda.ntt_leaf(x, tw)
        x_dm = jnp.asarray(to_jax_digits(x)[bit_reverse_perm(M)]
                           .transpose(2, 0, 1))               # [16, M, B]
        out = _MockRef(jnp.zeros_like(x_dm))
        mod._mk_ntt_kernel("fp252")(
            _MockRef(x_dm), jnp.asarray(mod._stage_tables_np(JF, M, inverse)),
            out)
        assert _agree(jnp.transpose(out.arr, (1, 2, 0)), got)


def test_powers_dev():
    base, start = 123456789, 987654321
    got = TF.decode_ints(powers_dev(TF, base, 37, CPU, start=start))
    assert got == [start * pow(base, i, P) % P for i in range(37)]
