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
from sandstorm_tpu_torch.fields import fp252_cuda
from sandstorm_tpu_torch.fields.fp252_cuda import (OPEN_GROUP, open_pairs,
                                                   open_pairs_plain,
                                                   pair_groups)
from sandstorm_tpu_torch.interop import (columns_from_jax, from_jax_digits,
                                        to_jax_digits)
from sandstorm_tpu_torch.stark.fri import fri_fold_device, fri_fold_host
from sandstorm_tpu_torch.stark.openings import open_columns

P = JF.MODULUS


def _digits(rng, n):
    return JF.encode_ints_np([rng.randrange(P) for _ in range(n)])


def test_opener_matches_pallas_interpret():
    """Smallest shape the Pallas opener takes: n = 2048 (T = 1024), K = 2
    points; 4 pairs over C = 3 columns, then an unsorted list over C = 6 in
    which point 1 names more columns than one group of the port's kernel
    holds and one pair comes twice."""
    from sandstorm_tpu.fields import fp252_pallas as fpp
    rng = random.Random(1)
    n, K, C = 2048, 2, 6
    T = fpp.SBT * 128
    cols = _digits(rng, C * n).reshape(C, n, 16)
    lo = _digits(rng, K * T).reshape(K, T, 16)
    hi = _digits(rng, K * (n // T)).reshape(K, n // T, 16)
    wide = [(1, 4), (0, 1), (1, 0), (1, 5), (1, 2), (0, 4), (1, 3), (1, 1),
            (1, 4)]
    assert sum(1 for k, _ in wide if k == 1) > OPEN_GROUP
    for pairs in ([(0, 0), (1, 0), (1, 2), (0, 1)], wide):
        kidx, cidx = [k for k, _ in pairs], [c for _, c in pairs]
        partials = fpp.open_pairs_partials(
            jnp.asarray(cols.transpose(0, 2, 1)),
            jnp.asarray(lo.transpose(0, 2, 1)),
            jnp.asarray(hi.transpose(0, 2, 1)), jnp.asarray(kidx, jnp.int32),
            jnp.asarray(cidx, jnp.int32), len(kidx), interpret=True)
        # the Pallas kernel leaves [P, 16, 8, 128] partial sums to the caller
        sums = JF.decode(jnp.transpose(partials, (0, 2, 3, 1)).reshape(
            len(kidx), -1, 16))
        want = [sum(int(v) for v in row) % P for row in sums]
        got = open_pairs(from_jax_digits(cols), from_jax_digits(lo),
                         from_jax_digits(hi), kidx, cidx)
        assert TF.decode_ints(got) == want


PAIR_LISTS = {
    "unsorted": [(2, 1), (0, 3), (1, 0), (0, 0), (2, 4), (1, 3), (0, 4)],
    "wide_point": [(1, c) for c in (5, 0, 3, 6, 1, 4, 2)] + [(0, 2), (2, 6)],
    "one_pair": [(1, 2)],
    "column_at_every_point": [(k, 3) for k in (2, 0, 1)] + [(0, 0), (2, 3)],
}


@pytest.mark.parametrize("case", sorted(PAIR_LISTS))
def test_pair_groups_cover_the_pairs(case):
    """pair_groups' table: every row one point and at most OPEN_GROUP of
    its columns, every pair position in exactly one slot, a point's power
    formed once per row (P + rows products per coefficient, not 2 P)."""
    pairs = PAIR_LISTS[case]
    table = pair_groups([k for k, _ in pairs], [c for _, c in pairs])
    assert table.dtype == np.int32 and table.shape[1] == 2 + 2 * OPEN_GROUP
    seen = []
    for row in table.tolist():
        k, ncols = row[0], row[1]
        assert 1 <= ncols <= OPEN_GROUP
        for c, p in zip(row[2:2 + ncols],
                        row[2 + OPEN_GROUP:2 + OPEN_GROUP + ncols]):
            assert pairs[p] == (k, c)
            seen.append(p)
    assert sorted(seen) == list(range(len(pairs)))
    per_point = {}
    for k, _ in pairs:
        per_point[k] = per_point.get(k, 0) + 1
    assert len(table) == sum(-(-m // OPEN_GROUP) for m in per_point.values())


@pytest.mark.parametrize("case", sorted(PAIR_LISTS))
def test_grouped_opener_equals_plain_in_pair_order(case):
    """open_pairs on CPU tensors runs the kernel's contract in plain ops
    (pair_groups, a point's powers once per group, the scatter back): it
    equals open_pairs_plain, pair by pair, and direct evaluation."""
    rng = random.Random(5)
    n, b, K, C = 64, 8, 3, 7
    cpu = torch.device("cpu")
    pts = [rng.randrange(P) for _ in range(K)]
    vals = [[rng.randrange(P) for _ in range(n)] for _ in range(C)]
    cols = torch.stack([TF.encode_ints(v, cpu) for v in vals])
    lo = torch.stack([TF.encode_ints([pow(z, i, P) for i in range(b)], cpu)
                      for z in pts])
    hi = torch.stack([TF.encode_ints([pow(z, b * i, P)
                                      for i in range(n // b)], cpu)
                      for z in pts])
    pairs = PAIR_LISTS[case]
    kidx, cidx = [k for k, _ in pairs], [c for _, c in pairs]
    got = open_pairs(cols, lo, hi, kidx, cidx)
    assert torch.equal(got, open_pairs_plain(cols, lo, hi, kidx, cidx))
    assert TF.decode_ints(got) == [
        sum(v * pow(pts[k], i, P) for i, v in enumerate(vals[c])) % P
        for k, c in pairs]
    assert open_pairs(cols, lo, hi, [], []).shape == (0, 8)


def test_opener_rejects_bad_pairs_and_non_cuda_tensors():
    """Indices out of range raise before any launch; a non-CPU tensor goes
    to the kernel wrapper, which raises rather than falling back."""
    z = torch.zeros((2, 16, 8), dtype=torch.int32)
    lo, hi = z[:, :4].contiguous(), z[:, :4].contiguous()
    for kidx, cidx in (([2], [0]), ([0], [2]), ([0, 1], [0])):
        with pytest.raises(ValueError, match="bad pair lists"):
            open_pairs(z, lo, hi, kidx, cidx)
    meta = torch.empty((2, 16, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        open_pairs(meta, lo, hi, [0], [1])
    assert fp252_cuda._native._lib is None


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
