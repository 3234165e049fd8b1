"""The port's OODS opener and FRI fold against the JAX package, on the CPU:
the pair-indexed opener against open_pairs_partials in Pallas interpret
mode and against the dense open_columns fallback; the fold against
fri_fold_device and the verifier's fri_fold_host."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.fields.fp252 import Fp252 as JF
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.fields.fp252_cuda import open_pairs
from sandstorm_tpu_torch.interop import (columns_from_jax, from_jax_digits,
                                        to_jax_digits)
from sandstorm_tpu_torch.stark.fri import fri_fold_device, fri_fold_host
from sandstorm_tpu_torch.stark.openings import open_columns

P = JF.MODULUS


def _digits(rng, n):
    return JF.encode_ints_np([rng.randrange(P) for _ in range(n)])


def test_opener_matches_pallas_interpret():
    """Smallest shape the Pallas opener takes: n = 2048 (T = 1024), K = 2
    points, C = 3 columns, 4 pairs."""
    from sandstorm_tpu.fields import fp252_pallas as fpp
    rng = random.Random(1)
    n, K, C = 2048, 2, 3
    T = fpp.SBT * 128
    cols = _digits(rng, C * n).reshape(C, n, 16)
    lo = _digits(rng, K * T).reshape(K, T, 16)
    hi = _digits(rng, K * (n // T)).reshape(K, n // T, 16)
    kidx, cidx = [0, 1, 1, 0], [0, 0, 2, 1]
    partials = fpp.open_pairs_partials(
        jnp.asarray(cols.transpose(0, 2, 1)), jnp.asarray(lo.transpose(0, 2, 1)),
        jnp.asarray(hi.transpose(0, 2, 1)), jnp.asarray(kidx, jnp.int32),
        jnp.asarray(cidx, jnp.int32), len(kidx), interpret=True)
    # the Pallas kernel leaves [P, 16, 8, 128] partial sums to the caller
    sums = JF.decode(jnp.transpose(partials, (0, 2, 3, 1)).reshape(
        len(kidx), -1, 16))
    want = [sum(int(v) for v in row) % P for row in sums]
    got = open_pairs(from_jax_digits(cols), from_jax_digits(lo),
                     from_jax_digits(hi), torch.tensor(kidx, dtype=torch.int32),
                     torch.tensor(cidx, dtype=torch.int32))
    assert TF.decode_ints(got) == want


def test_open_columns_matches_jax_dense():
    """Every trace-argument pair plus the extra point, against the JAX
    package's dense openings (SANDSTORM_TPU_PALLAS unset on the CPU)."""
    from sandstorm_tpu.stark.openings import open_columns as jax_open
    rng = random.Random(2)
    n = 64
    coeffs = {c: _digits(rng, n) for c in (0, 1, 2, 1000, 1001)}
    targs = [(0, 0), (0, 1), (1, 0), (2, 3), (1, 3), (2, 7)]
    z, g = rng.randrange(P), JF.root_of_unity_int(n)
    z2 = z * z % P
    extra_cols = [[1000, 1001]]
    want = jax_open(JF, {k: jnp.asarray(v) for k, v in coeffs.items()},
                    targs, z, g, n, extra_points=[z2], extra_cols=extra_cols)
    got = open_columns(TF, columns_from_jax(coeffs), targs, z, g, n,
                       extra_points=[z2], extra_cols=extra_cols)
    # the dense form opens every column at every point; compare the pairs
    assert got[0] == {k: want[0][k] for k in targs}
    assert got[1] == [{c: want[1][0][c] for c in extra_cols[0]}]
    # and against direct evaluation at z * g^3
    x = z * pow(g, 3, P) % P
    vals = JF.decode_ints(jnp.asarray(coeffs[2]))
    assert got[0][(2, 3)] == sum(c * pow(x, i, P)
                                 for i, c in enumerate(vals)) % P


def test_fri_fold_matches_jax_and_host():
    from sandstorm_tpu.stark.fri import fri_fold_device as jax_fold
    rng = random.Random(3)
    N, f, coset = 64, 8, JF.GENERATOR
    beta = rng.randrange(2, P)
    vals = [rng.randrange(P) for _ in range(N)]
    digits = JF.encode_ints_np(vals)
    got = fri_fold_device(TF, from_jax_digits(digits), coset, N, f, beta)
    want = jax_fold(JF, jnp.asarray(digits), coset, N, f, beta)
    assert np.array_equal(to_jax_digits(got), np.asarray(want))


@pytest.mark.parametrize("f", [2, 4, 8])
def test_fri_fold_matches_host_fold(f):
    rng = random.Random(4)
    N, coset = 32, TF.GENERATOR
    beta = rng.randrange(2, P)
    vals = [rng.randrange(P) for _ in range(N)]
    folded = TF.decode_ints(fri_fold_device(
        TF, TF.encode_ints(vals, torch.device("cpu")), coset, N, f, beta))
    w = TF.root_of_unity_int(N)
    for i in range(N // f):
        row = [vals[t * (N // f) + i] for t in range(f)]
        assert folded[i] == fri_fold_host(P, row, i, N, coset, w, f, beta)
