"""The segmented batch inversion of the port (fields/scan.py
batch_inv_many, fields/fp252_cuda.py batch_inv_segments and inv_tables)
and its batched callers, on the CPU.

batch_inv_many over arrays of mixed lengths and widths, with a zero in one
column of one array, against the JAX package's Fp252.batch_inv array by
array; the zerofier inverses of the plain, recursive and starknet AIRs
(air/expr.py _hoisted_zinvs, one batch_inv_many a level) against the
per-node route; the tile table of fp252_batch_inv: every row of every
column of every segment in exactly one tile, no tile across a column or a
segment.  Inputs are made with numpy from a seed.  Tolerance 0: the
arithmetic is exact.  The kernels are held to these plain versions on the
card by chip_smoke.py (phase 3k) and tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.fields.fp252 import Fp252 as JF
from sandstorm_tpu_torch.air import expr as E
from sandstorm_tpu_torch.fields import fp252_cuda as fc
from sandstorm_tpu_torch.fields import scan
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.fields.gl3 import GL3
from sandstorm_tpu_torch.fields.goldilocks import GL
from sandstorm_tpu_torch.interop import from_jax_digits, to_jax_digits
from sandstorm_tpu_torch.stark.prover import _DomainCache

P = TF.MODULUS
CPU = torch.device("cpu")
LENGTHS = [1, 2, 3, 17, 1 << 10]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops on the CPU: one intra-op thread a test worker
    keeps the workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, C, zero):
    """One [n] (C = 1) or [n, C] array a length of LENGTHS, as JAX digit
    arrays, port tensors and python ints; with `zero`, the 17-row array
    holds a 0 at row 5 of its last column."""
    rng = np.random.default_rng(seed)
    out = []
    for n in LENGTHS:
        vals = [int.from_bytes(rng.bytes(32), "little") % P
                for _ in range(n * C)]
        if zero and n == 17:
            vals[5 * C + C - 1] = 0
        shape = (n,) if C == 1 else (n, C)
        digits = JF.encode_ints_np(vals).reshape(shape + (16,))
        out.append((jnp.asarray(digits), from_jax_digits(digits), vals))
    return out


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("C", [1, 3])
def test_batch_inv_many_matches_jax_array_by_array(C, zero):
    """Every array of one call equals the JAX package's Fp252.batch_inv of
    it alone and the per-array batch_inv; a zero zeroes its own column and
    no other column or array."""
    arrays = _arrays(10 * C + zero, C, zero)
    got = scan.batch_inv_many(TF, [t for _, t, _ in arrays])
    assert len(got) == len(arrays)
    for (ja, ta, vals), g in zip(arrays, got):
        assert g.shape == ta.shape
        assert np.array_equal(np.asarray(JF.batch_inv(ja)), to_jax_digits(g))
        assert torch.equal(g, TF.batch_inv(ta))
        n = len(vals) // C
        for c in range(C):
            col = vals[c::C]
            inv = TF.decode_ints(g.reshape(n, C, 8)[:, c])
            if 0 in col:
                assert inv == [0] * n
            else:
                assert inv == [pow(v, -1, P) for v in col]


@pytest.mark.parametrize("F", [GL, GL3])
def test_batch_inv_many_of_other_fields_is_per_array(F):
    """GL and GL3 invert each array on its own, as batch_inv does."""
    rng = np.random.default_rng(7)
    arrays = [F.encode_ints([int(v) % F.MODULUS for v in rng.integers(
        1, 1 << 62, size=n)], CPU) for n in (1, 5, 64)]
    got = scan.batch_inv_many(F, arrays)
    for a, g in zip(arrays, got):
        assert torch.equal(g, F.batch_inv(a))
        assert F.decode_ints(F.mul(a, g)) == [1] * a.shape[0]


def _nested_dag(N):
    """Zerofier-like inverses, one nested inside another's argument."""
    inner = 1 / (E.X.pow(N // 4) - 3)
    return [E.Trace(0, 0) / (E.X.pow(N // 2) - 1),
            E.Trace(0, 0) / (E.X.pow(N // 8) - inner),
            E.Trace(0, 1) * inner]


@pytest.mark.parametrize("layout", ["plain", "recursive", "starknet",
                                    "nested"])
def test_hoisted_zinvs_batched_matches_per_node(layout, monkeypatch):
    """_hoisted_zinvs, its arguments inverted together one batch_inv_many a
    level, equals the per-node route (each inv node evaluated with its own
    batch_inv) at small n: the plain layout (n = 16, blowup 2), the
    recursive one (n = 4096, blowup 1), starknet (n = 2^15, blowup 1, the
    smallest it builds) and a DAG with a nested inverse (two levels)."""
    if layout == "nested":
        n, blowup = 64, 2
        cons = _nested_dag(n * blowup)
    else:
        from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
        from sandstorm_tpu_torch.layouts.recursive.air import \
            RecursiveAirConfig
        from sandstorm_tpu_torch.layouts.starknet.air import \
            StarknetAirConfig
        A, n, blowup = {"plain": (PlainAirConfig, 16, 2),
                        "recursive": (RecursiveAirConfig, 4096, 1),
                        "starknet": (StarknetAirConfig, 1 << 15, 1)}[layout]
        cons = A.constraints(n, P, TF.root_of_unity_int(n))
    N = n * blowup
    dom = _DomainCache(TF, N, TF.GENERATOR, CPU)
    ctx = E.LdeContext(TF, {0: TF.zeros((N,), CPU)}, blowup, dom.domain,
                       dom.x_pow, challenges=[], hints=[], periodic=[])
    calls = []

    def counted(F, arrays):
        calls.append(len(arrays))
        return scan.batch_inv_many(F, arrays)

    monkeypatch.setattr(E, "batch_inv_many", counted)
    got = E._hoisted_zinvs(TF, cons, ctx, N)
    want, memo = {}, {}
    for n_ in E._domain_only_invs(cons):
        period = E._domain_period(n_, N)
        if period:
            want[n_.key] = (E._eval_domain_node(TF, n_, dom.x_pow, N, memo,
                                                CPU)[0], period)
    assert got.keys() == want.keys() and len(got) > 0
    for key, (arr, period) in want.items():
        assert got[key][1] == period == arr.shape[0]
        assert torch.equal(got[key][0], arr)
    assert sum(calls) == len(want)
    assert len(calls) == (2 if layout == "nested" else 1)


@pytest.mark.parametrize("shapes,run", [
    ([(1, 1)], 1), ([(256, 1)], 1), ([(257, 2)], 1),
    ([(1, 1), (2, 3), (31, 1), (4097, 2)], 16),
    ([(1 << 12, 1), (1, 4), (5000, 1), (256 * 32 + 1, 3)], 32),
    ([(3, 1)] * 5 + [(770, 1)], 3)])
def test_inv_tables_cover_every_row_once(shapes, run):
    """Each tile lies in one column of one segment, a column's tiles come
    in order with consecutive indices 0 .. K - 1, only a column's last
    tile is short, and every row of every column is in exactly one tile."""
    tiles = fc.inv_tables(shapes, run)
    tile = fc.SCAN_THREADS * run
    assert tiles.dtype == np.int64 and tiles.shape[1] == 6
    seen = {(s, c): np.zeros(n, dtype=np.int64)
            for s, (n, C) in enumerate(shapes) for c in range(C)}
    prev = None
    for s, c, first, rows, k, K in tiles.tolist():
        n, C = shapes[s]
        assert 0 <= c < C and 0 < rows <= tile and first + rows <= n
        assert first == k * tile and K == -(-n // tile)
        assert rows == tile or k == K - 1
        if k:
            assert prev == (s, c, k - 1)
        prev = (s, c, k)
        seen[(s, c)][first:first + rows] += 1
    assert all((v == 1).all() for v in seen.values())
    assert len(tiles) == sum(C * -(-n // tile) for n, C in shapes)
