"""The port's redesigned kernels against their plain versions on a CUDA
card, away from the main path's shapes: every leaf length, ragged batches,
four-step widths that no tile of adjacent transforms divides, pair lists
that split into several groups; the running-product scan and the
segmented batch inversion at ragged lengths, mixed segments with zeros
and 20 repeats (the look-back), DEEP at each layout's trace arguments and at wrapping and
negative offsets, the unreduced accumulate, each layout's generated
constraint-group kernels and groups of 1, 8 and 17 folds against their
interpreter; the four-step exchange NTT on a virtual mesh of the card;
the Goldilocks and GF(p^3) route (gl_scan_mul and gl_batch_inv at ragged
lengths, mixed segments with zeros and repeats, gl_deep_compose at
wrapping and negative offsets, the pair-indexed gl_open_pairs with
base-field columns, the plain layout's typed group kernels rendered for
both fields and at p - 1, the GF(p^3) product's three forms); the
one-launch gl_batch_inv around its tiles with no synchronize, a zero in
one tile of many at 2^20 rows in 10 repeats, column groups and more
segments than a launch takes, p - 1, the device inversion (gl::inv, of
the norm over GF(p^3)) on edge values; gl_deep_compose with base-field
columns named base, at p - 1, and refusing a base column that is not
one.
chip_smoke.py holds the same kernels to their plain versions at the main
path's shapes.

These tests need a card and nvcc: each is marked `cuda` and skips where
torch finds no CUDA device.  The file imports nothing of JAX, so on a
machine without it run

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py sets up the JAX package's CPU backend).  Tolerance 0:
the arithmetic is exact.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sandstorm_tpu_torch.fields import fp252_cuda, gl_cuda  # noqa: E402
from sandstorm_tpu_torch.fields.fp252 import Fp252  # noqa: E402
from sandstorm_tpu_torch.fields.goldilocks import GL  # noqa: E402
from sandstorm_tpu_torch.fields.scan import (  # noqa: E402
    batch_inv_many, prefix_mul, prefix_scan)
from sandstorm_tpu_torch.ntt import ntt_cuda  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


def _rand_gl(rng, shape, dev):
    w = rng.integers(0, 1 << 32, size=tuple(shape) + (2,), dtype=np.uint64)
    w[..., 1] %= 0xFFFFFFFF                   # canonical: hi word < 2^32 - 1
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


def _rand_fp(rng, shape, dev):
    w = rng.integers(0, 1 << 32, size=tuple(shape) + (8,), dtype=np.uint64)
    w[..., 7] &= (1 << 27) - 1
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32, 128, 512, 1024, 2048])
def test_gl_ntt_leaf_every_length_and_ragged_batches(dev, M):
    rng = np.random.default_rng(M)
    for B in (1, 3, 5, 17, 130, 1000):
        for inverse in (False, True):
            x = _rand_gl(rng, (M, B), dev)
            tw = ntt_cuda.stage_table(GL, M, inverse, dev)
            assert torch.equal(
                ntt_cuda.gl_ntt_leaf(x, tw),
                ntt_cuda.ntt_leaf_plain(x, tw, gl_cuda.PLAIN)), (M, B)


@pytest.mark.parametrize("M,C,Bi", [(16, 8, 1), (64, 7, 3), (32, 9, 5),
                                    (256, 5, 15), (2048, 3, 15), (8, 3, 2),
                                    (1024, 16, 1), (2, 5, 3)])
def test_gl_ntt_leaf_fused_widths_no_tile_divides(dev, M, C, Bi):
    rng = np.random.default_rng(M + C + Bi)
    x = _rand_gl(rng, (M, C * Bi), dev)
    tw = ntt_cuda.stage_table(GL, M, False, dev)
    rc = _rand_gl(rng, (M, C, 1), dev)
    assert torch.equal(ntt_cuda.gl_ntt_leaf_fused(x, tw, rc, Bi),
                       ntt_cuda.gl_ntt_leaf_fused_plain(x, tw, rc, Bi))


def test_gl_leaves_refuse_what_the_kernel_does_not_take(dev):
    x = _rand_gl(np.random.default_rng(0), (4096, 2), dev)
    with pytest.raises(ValueError, match="bad shape"):
        ntt_cuda.gl_ntt_leaf(x, ntt_cuda.stage_table(GL, 4096, False, dev))
    tw = ntt_cuda.stage_table(GL, 16, False, dev)
    with pytest.raises(ValueError, match="bad twiddles"):
        ntt_cuda.gl_ntt_leaf_fused(x[:16].contiguous(), tw,
                                   x[:16, :1].reshape(16, 1, 1, 2), 3)


@pytest.mark.parametrize("pairs", [
    [(0, 0)],
    [(2, 5), (0, 1), (2, 0), (1, 1), (0, 5), (2, 5)],
    [(1, c) for c in range(11)] + [(0, 3)],
    [(k, 4) for k in range(3)],
    [(k, c) for c in range(11) for k in range(3)],
    # starknet's shape: 192 points, most naming one or two columns, 192
    # groups (the recursive path's pair list makes 81)
    [(k, (7 * k) % 11) for k in range(192)]
    + [(k, (7 * k + 3) % 11) for k in range(0, 192, 12)],
], ids=["one_pair", "unsorted_repeated", "wide_point", "column_at_every_point",
        "dense", "starknet_groups"])
def test_open_pairs_groups_and_ranges(dev, pairs):
    from sandstorm_tpu_torch.stark.openings import point_powers
    rng = np.random.default_rng(len(pairs))
    prng = random.Random(len(pairs))
    n, C, b = 4096, 11, 64
    K = max(3, 1 + max(k for k, _ in pairs))
    kidx, cidx = [k for k, _ in pairs], [c for _, c in pairs]
    if K > 3:
        assert fp252_cuda.pair_groups(kidx, cidx).shape[0] > 81
    P = Fp252.MODULUS
    pts = [prng.randrange(P) for _ in range(K)]
    lo = point_powers(Fp252, pts, b, dev)
    hi = point_powers(Fp252, [pow(z, b, P) for z in pts], n // b, dev)
    cols = _rand_fp(rng, (C, n), dev)
    assert torch.equal(fp252_cuda.open_pairs(cols, lo, hi, kidx, cidx),
                       fp252_cuda.open_pairs_plain(cols, lo, hi, kidx, cidx))


def _rand_words(rng, shape, dev):
    return torch.from_numpy(rng.integers(0, 1 << 32, size=shape,
                                         dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)


@pytest.mark.parametrize("W", [0, 1, 16, 33, 34, 35, 40, 56, 64, 67, 68, 69,
                               72])
def test_keccak_rows_rate_boundary_and_masks(dev, W):
    """keccak_rows against its plain twin on the card at every word count
    around the 136-byte rate (one, two and three permutations), ragged row
    counts and the three masks, and at starknet's 9-felt rows (72 words);
    a few rows against the host keccak256."""
    from sandstorm_tpu_torch.crypto.hashes import keccak256
    from sandstorm_tpu_torch.hashing import keccak
    rng = np.random.default_rng(W)
    for n in (1, 129, 1000):
        msg = _rand_words(rng, (n, W), dev)
        for keep in (8, 5, 0):
            got = keccak.keccak256_words(msg, keep_words=keep)
            assert torch.equal(got, keccak.keccak256_words_plain(msg, keep))
        host = msg[:5].cpu().numpy().view(np.uint32)
        dig = keccak.keccak256_words(msg[:5]).cpu().numpy().view(np.uint32)
        for r in range(min(n, 5)):
            assert dig[r].astype("<u4").tobytes() == keccak256(
                host[r].astype("<u4").tobytes())


@pytest.mark.parametrize("hash_name", ["keccak", "blake2s"])
def test_pow_grind_returns_the_smallest_hit(dev, hash_name):
    """One batch: the kernel's offset equals the plain twin's first hit on
    the card, the same in every repeat (atomicMin, whatever the block
    order), and no earlier nonce passes on the host; a batch with no hit
    gives BATCH; a grind over several batches equals the twin's; and a
    window of several batches (one launch, early exit) equals the twin's
    over the same window."""
    from sandstorm_tpu_torch.crypto import grind as g
    from sandstorm_tpu_torch.crypto.hashes import blake2s256, keccak256
    H = keccak256 if hash_name == "keccak" else blake2s256
    rng = np.random.default_rng(3)
    for bits in (4, 8, 12):
        prefix = rng.bytes(32)
        words = torch.from_numpy(np.frombuffer(prefix, "<u4").view(np.int32)
                                 .copy()).to(dev)
        for nonce0 in (0, 1, 65535, (1 << 40) + 7):
            got = {g.pow_grind(words, nonce0, bits, hash_name)
                   for _ in range(5)}
            assert got == {g.pow_grind_plain(words, nonce0, bits, hash_name)}
            idx = got.pop()
            if idx < g.BATCH and idx < 300:
                for k in range(idx + 1):
                    h = H(prefix + (nonce0 + k).to_bytes(8, "big"))
                    lead = int.from_bytes(h[:4], "big")
                    assert (lead < 1 << (32 - bits)) == (k == idx)
    # no hit at 32 bits in this batch (one in 2^16 batches has one)
    assert g.pow_grind(words, 0, 32, hash_name) == g.pow_grind_plain(
        words, 0, 32, hash_name)
    start = 5
    nonce = g.grind(hash_name, prefix, 18, start, device=dev)
    n0 = start
    while True:
        idx = g.pow_grind_plain(words, n0, 18, hash_name)
        if idx < g.BATCH:
            assert nonce == n0 + idx
            break
        n0 += g.BATCH
    # windows of several batches in one launch: the first hit in batch 0,
    # in a later batch or in none, the same in every repeat
    for bits, batches in ((8, 4), (18, 8), (32, 2)):
        for nonce0 in (1, 3 * g.BATCH + 11):
            got = {g.pow_grind(words, nonce0, bits, hash_name, batches)
                   for _ in range(3)}
            assert got == {g.pow_grind_plain(words, nonce0, bits, hash_name,
                                             batches)}


# around a tile: run_length gives runs of 1 row below 2 x 256 x (the
# card's SMs) rows, so a tile is 256 rows there; 2^18 + 5 rows take runs
# of 2 on 132 SMs: 513 tiles of 512, the last of 5 rows
SCAN_SIZES = [1, 2, 31, 32, 33, 255, 256, 257, (1 << 18) + 5]


@pytest.mark.parametrize("n", SCAN_SIZES)
def test_scan_mul_matches_plain(dev, n):
    """fp252_scan_mul against its plain version (prefix_scan of mul_plain,
    on the card) at ragged lengths around a tile, one and four columns,
    both directions."""
    rng = np.random.default_rng(n)
    for shape in ((n,), (n, 4)):
        x = _rand_fp(rng, shape, dev)
        for reverse in (False, True):
            want = prefix_scan(fp252_cuda.mul_plain, x, reverse)
            assert torch.equal(prefix_mul(Fp252, x, reverse), want)


@pytest.mark.parametrize("n", SCAN_SIZES)
def test_batch_inv_matches_plain(dev, n):
    """fp252_batch_inv of one array against batch_inv_plain on the card, one
    and four columns; with a zero in one column, that column's inverses
    are all zero."""
    rng = np.random.default_rng(n + 1)
    for shape in ((n,), (n, 4)):
        x = _rand_fp(rng, shape, dev)
        (got,) = batch_inv_many(Fp252, [x])
        assert torch.equal(got, fp252_cuda.batch_inv_plain(x))
        x.view(n, -1, 8)[n // 2, -1] = 0
        (got,) = batch_inv_many(Fp252, [x])
        assert torch.equal(got, fp252_cuda.batch_inv_plain(x))
        assert not got.view(n, -1, 8)[:, -1].any()


def test_batch_inv_segments_mixed_lengths_with_zeros(dev):
    """One call over segments of mixed lengths and widths (1 row to many
    tiles), zeros in two columns of two segments: each array equals
    batch_inv_plain of it alone, and Fp252.batch_inv (the same call with
    one array); an empty array comes back empty."""
    rng = np.random.default_rng(99)
    shapes = [(1,), (2, 3), (257,), (5000, 2), ((1 << 18) + 5,), (33, 4),
              (0,), (70001,)]
    xs = [_rand_fp(rng, s, dev) for s in shapes]
    xs[3].view(5000, 2, 8)[4999, 0] = 0
    xs[7][0] = 0
    got = batch_inv_many(Fp252, xs)
    for x, g in zip(xs, got):
        assert g.shape == x.shape
        assert torch.equal(g, fp252_cuda.batch_inv_plain(x))
    assert not got[3].view(5000, 2, 8)[:, 0].any()
    assert got[3].view(5000, 2, 8)[:, 1].any(dim=-1).all()
    assert not got[7].any()
    assert torch.equal(Fp252.batch_inv(xs[4]), got[4])


def test_look_back_repeats_bit_exact(dev):
    """20 calls of each kernel at a many-tile size (2^20 rows of one column,
    and of three in reverse: hundreds of tiles a call), all equal to the
    first and to the plain version: a race in the look-back shows as a
    rare wrong row."""
    rng = np.random.default_rng(20)
    x = _rand_fp(rng, (1 << 20,), dev)
    x3 = _rand_fp(rng, (1 << 20, 3), dev)
    first = [prefix_mul(Fp252, x), prefix_mul(Fp252, x3, True),
             batch_inv_many(Fp252, [x, x3])]
    assert torch.equal(first[0], prefix_scan(fp252_cuda.mul_plain, x))
    assert torch.equal(first[1],
                       prefix_scan(fp252_cuda.mul_plain, x3, True))
    assert torch.equal(first[2][1], fp252_cuda.batch_inv_plain(x3))
    for _ in range(20):
        assert torch.equal(prefix_mul(Fp252, x), first[0])
        assert torch.equal(prefix_mul(Fp252, x3, True), first[1])
        got = batch_inv_many(Fp252, [x, x3])
        assert torch.equal(got[0], first[2][0])
        assert torch.equal(got[1], first[2][1])


def _deep_inputs(targs, n, blowup, dev, seed):
    """Random LDE columns (views of one stacked tensor, as the prover's
    LDEs are), OODS values, z and alpha for these trace arguments."""
    P = Fp252.MODULUS
    rng = np.random.default_rng(seed)
    prng = random.Random(seed)
    N = n * blowup
    ncols = 1 + max(c for c, _ in targs)
    stack = _rand_fp(rng, (N, ncols + 2), dev)
    cols = dict(enumerate(stack[:, :ncols].unbind(1)))
    comp = list(stack[:, ncols:].unbind(1))
    tv = [prng.randrange(P) for _ in targs]
    cv = [prng.randrange(P) for _ in range(2)]
    z, alpha = prng.randrange(P), prng.randrange(P)
    return cols, comp, tv, cv, z, alpha


def _deep_both(targs, n, blowup, dev, seed):
    """deep_compose on the card (two batch_invs and the kernel), and on the
    CPU its plain version _deep_shifted and the windowed _deep_compose."""
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.stark import prover
    cols, comp, tv, cv, z, alpha = _deep_inputs(targs, n, blowup, dev, seed)
    N = n * blowup
    g = Fp252.root_of_unity_int(n)
    before = _native.LAUNCHES["deep_compose"]
    got = prover.deep_compose(
        Fp252, prover._DomainCache(Fp252, N, Fp252.GENERATOR, dev), targs,
        cols, comp, tv, cv, z, g, n, alpha)
    assert _native.LAUNCHES["deep_compose"] - before == 1
    cpu = torch.device("cpu")
    args = (targs, {c: v.cpu() for c, v in cols.items()},
            [v.cpu() for v in comp], tv, cv, z, g, n, alpha)
    dom = prover._DomainCache(Fp252, N, Fp252.GENERATOR, cpu)
    return (got.cpu(), prover._deep_shifted(Fp252, dom, *args),
            prover._deep_compose(Fp252, dom, *args))


@pytest.mark.parametrize("layout", ["plain", "recursive", "starknet"])
def test_deep_compose_matches_plain(dev, layout):
    """deep_compose's kernel on the card against its plain version
    (_deep_shifted) and the windowed _deep_compose on the CPU, at a
    layout's trace arguments over random columns (N = 2^11)."""
    from sandstorm_tpu_torch.air.expr import trace_arguments
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.layouts.recursive.air import RecursiveAirConfig
    from sandstorm_tpu_torch.layouts.starknet.air import StarknetAirConfig
    A, n_air = {"plain": (PlainAirConfig, 1 << 4),
                "recursive": (RecursiveAirConfig, 1 << 12),
                "starknet": (StarknetAirConfig, 1 << 15)}[layout]
    P = Fp252.MODULUS
    targs = trace_arguments(A.constraints(n_air, P,
                                          Fp252.root_of_unity_int(n_air)))
    got, shifted, want = _deep_both(targs, 1 << 10, 2, dev, len(targs))
    assert torch.equal(got, shifted)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,blowup", [(64, 2), (32, 4), (128, 1)])
def test_deep_compose_wrapping_and_negative_offsets(dev, n, blowup):
    """Offsets below 0, of a whole trace length and beyond it, whose shifted
    reads wrap around the domain's end; a point of 20 terms (more than one
    redc takes: split in two with one shift); the kernel against both plain
    versions."""
    targs = [(0, 0), (1, -1), (2, -3), (0, n), (1, n + 5), (2, 2 * n - 1),
             (0, -n - 2), (1, 3)] + [(c, 7) for c in range(20)]
    got, shifted, want = _deep_both(targs, n, blowup, dev, n + blowup)
    assert torch.equal(got, shifted)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 8, 15, 16])
def test_dot_accumulate_matches_plain_c_and_plain(dev, k):
    """fp252.cuh's unreduced accumulate (k 512-bit products, one redc),
    through the PTX carry chain and its plain-C twin on the card, against
    the plain sum of montmuls on the CPU, on random elements led by p - 1
    in every term (the largest sums)."""
    rng = np.random.default_rng(k)
    a, b = _rand_fp(rng, (4099, k), dev), _rand_fp(rng, (4099, k), dev)
    pm1 = Fp252.encode_ints([Fp252.MODULUS - 1], dev)[0]
    a[:2] = pm1
    b[:1] = pm1
    want = fp252_cuda.dot_plain(a.cpu(), b.cpu())
    assert torch.equal(fp252_cuda.dot(a, b).cpu(), want)
    assert torch.equal(fp252_cuda.dot(a, b, plain_c=True).cpu(), want)


def _fold_inputs(layout, n, blowup, dev):
    """A layout's constraints, an LdeContext over random columns with its
    periodic columns on `dev`, and alpha powers."""
    from sandstorm_tpu_torch.air.expr import LdeContext, walk
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.layouts.recursive.air import RecursiveAirConfig
    from sandstorm_tpu_torch.layouts.starknet.air import StarknetAirConfig
    from sandstorm_tpu_torch.stark.prover import _DomainCache
    A = {"plain": PlainAirConfig, "recursive": RecursiveAirConfig,
         "starknet": StarknetAirConfig}[layout]
    P = Fp252.MODULUS
    cons = A.constraints(n, P, Fp252.root_of_unity_int(n))
    keys = [nd.key for nd in walk(cons)]
    prng = random.Random(n)
    rng = np.random.default_rng(n)
    N = n * blowup
    ncols = 1 + max(k[1] for k in keys if k[0] == "trace")
    stack = _rand_fp(rng, (N, ncols), dev)
    dom = _DomainCache(Fp252, N, Fp252.GENERATOR, dev)
    pcs = A.periodic_columns(n) if hasattr(A, "periodic_columns") else []

    def scalars(kind):
        count = 1 + max((k[1] for k in keys if k[0] == kind), default=-1)
        return [Fp252.encode_int(prng.randrange(P), dev)
                for _ in range(count)]

    ctx = LdeContext(Fp252, dict(enumerate(stack.unbind(1))), blowup,
                     dom.domain, dom.x_pow, challenges=scalars("challenge"),
                     hints=scalars("hint"),
                     periodic=[pc.lde_fn(Fp252, dom) for pc in pcs])
    alpha = prng.randrange(P)
    return cons, ctx, N, [pow(alpha, i, P) for i in range(len(cons))]


def _to_cpu(ctx):
    from sandstorm_tpu_torch.air.expr import LdeContext
    from sandstorm_tpu_torch.stark.prover import _DomainCache
    cpu = torch.device("cpu")
    N = next(iter(ctx.columns.values())).shape[0]
    dom = _DomainCache(Fp252, N, Fp252.GENERATOR, cpu)
    return LdeContext(Fp252, {c: v.cpu() for c, v in ctx.columns.items()},
                      ctx.blowup, dom.domain, dom.x_pow,
                      [c.cpu() for c in ctx.challenges],
                      [h.cpu() for h in ctx.hints],
                      [lambda f=f: f().cpu() for f in ctx.periodic])


@pytest.mark.parametrize("layout,n,blowup", [("plain", 16, 4),
                                             ("plain", 1 << 10, 2),
                                             ("recursive", 1 << 12, 2),
                                             ("starknet", 1 << 15, 1)])
def test_air_group_kernels_match_the_interpreter(dev, layout, n, blowup):
    """Each layout's generated group kernels (evaluate_lde_folded on the
    card, whole domain and in windows) against the plain interpreter on
    the CPU; the starknet DAG on three windows of 256 rows (its
    interpreter takes minutes over all 2^15), the last with offsets
    wrapping around the domain's end; and against the eager walk on the
    card over the whole domain."""
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.air import codegen
    from sandstorm_tpu_torch.air.expr import evaluate_lde, evaluate_lde_folded
    cons, ctx, N, coeffs = _fold_inputs(layout, n, blowup, dev)
    before = _native.LAUNCHES["air_group"]
    got = evaluate_lde_folded(cons, ctx, N, coeffs)
    assert _native.LAUNCHES["air_group"] - before == -(-len(cons) // 8)
    assert torch.equal(evaluate_lde_folded(cons, ctx, N, coeffs,
                                           chunk_size=N // 4), got)
    starts = [0, N // 2, N - 256] if layout == "starknet" else [0]
    B = 256 if layout == "starknet" else N
    run = codegen.run_group

    def some_windows(F, plan, g, tables, scalars, bl, row0, nrows, out,
                     accumulate):
        if row0 in starts:
            run(F, plan, g, tables, scalars, bl, row0, nrows, out, accumulate)
        else:
            out.zero_()

    codegen.run_group = some_windows
    try:
        want = evaluate_lde_folded(cons, _to_cpu(ctx), N, coeffs,
                                   chunk_size=B)
    finally:
        codegen.run_group = run
    for s in starts:
        assert torch.equal(got[s:s + B].cpu(), want[s:s + B])
    alpha_pows = Fp252.encode_ints(coeffs, dev)

    def fold(acc, v, i):
        t = Fp252.mul(v, alpha_pows[i])
        return t if acc is None else Fp252.add(acc, t)

    assert torch.equal(evaluate_lde(cons, ctx, N, fold=fold), got)


def test_air_group_negative_offsets_and_pow(dev):
    """A DAG with negative trace offsets, an offset of a whole trace
    length, pows of per-row values, a negation and scalar subtrees with an
    inverse: the kernels against the interpreter (group size 2)."""
    from sandstorm_tpu_torch.air import expr as E
    from sandstorm_tpu_torch.stark.prover import _DomainCache
    N, blowup = 64, 2
    P = Fp252.MODULUS
    prng = random.Random(5)
    t0, t1 = E.Trace(0, 0), E.Trace(1, 1)
    tm, tw = E.Trace(1, -3), E.Trace(0, -N)
    exprs = [tm * t0 - E.Challenge(0),
             (tw - tm.pow(2)) / (E.X - 5) + E.X.pow(N // 2),
             -tm * E.Challenge(0) * E.Challenge(0)
             - E.Constant(5) / E.Constant(7),
             (tm + t1).pow(5) / (E.X.pow(N // 8) - 1), E.Constant(3)]
    coeffs = [prng.randrange(P) for _ in exprs]
    out = {}
    for d in (dev, torch.device("cpu")):
        cols = {i: Fp252.encode_ints([random.Random(i).randrange(P)
                                      for _ in range(N)], d)
                for i in range(2)}
        dom = _DomainCache(Fp252, N, Fp252.GENERATOR, d)
        ctx = E.LdeContext(Fp252, cols, blowup, dom.domain, dom.x_pow,
                           challenges=[Fp252.encode_int(12345, d)])
        out[d.type] = E.evaluate_lde_folded(exprs, ctx, N, coeffs,
                                            group_size=2).cpu()
    assert torch.equal(out["cuda"], out["cpu"])


@pytest.mark.parametrize("nfolds", [1, 8, 17])
def test_air_group_fold_counts(dev, nfolds):
    """One group of 1, 8 and 17 constraints (17: past the 16 products one
    redc takes, so the fold reduces twice), read at positive and negative
    offsets and in a periodic zerofier: the kernel against the
    interpreter."""
    from sandstorm_tpu_torch.air import expr as E
    from sandstorm_tpu_torch.stark.prover import _DomainCache
    N, blowup = 256, 4
    P = Fp252.MODULUS
    prng = random.Random(nfolds)
    exprs = []
    for k in range(nfolds):
        t = E.Trace(k % 3, k - 4) * E.Trace((k + 1) % 3, -k)
        exprs.append((t - E.Challenge(0) * E.Trace(k % 3, 0))
                     / (E.X.pow(N // 32) - 1) if k % 2 else t + E.X)
    coeffs = [prng.randrange(P) for _ in exprs]
    out = {}
    for d in (dev, torch.device("cpu")):
        cols = {i: Fp252.encode_ints([random.Random(i).randrange(P)
                                      for _ in range(N)], d)
                for i in range(3)}
        dom = _DomainCache(Fp252, N, Fp252.GENERATOR, d)
        ctx = E.LdeContext(Fp252, cols, blowup, dom.domain, dom.x_pow,
                           challenges=[Fp252.encode_int(777, d)])
        out[d.type] = E.evaluate_lde_folded(exprs, ctx, N, coeffs,
                                            group_size=nfolds).cpu()
    assert torch.equal(out["cuda"], out["cpu"])


@pytest.mark.parametrize("field,n,B", [("fp252", 1 << 12, 3),
                                       ("fp252", 1 << 19, 2),
                                       ("goldilocks", 1 << 16, 5),
                                       ("gl3", 1 << 12, 2)])
def test_dist_ntt_on_a_card_mesh(dev, field, n, B):
    """The four-step exchange NTT over a virtual mesh of 4 and 8 shards on
    the card (the shards' leaves, the twiddle multiply, the exchanges as
    copies) equals the single-device transform, both directions, with
    the columns on the batch axis; ntt() under the mesh routes to it."""
    from sandstorm_tpu_torch.fields.gl3 import GL3
    from sandstorm_tpu_torch.ntt import ntt
    from sandstorm_tpu_torch.parallel import dist, make_mesh, runtime
    F = {"fp252": Fp252, "goldilocks": GL, "gl3": GL3}[field]
    rng = np.random.default_rng(n + B)
    x = (_rand_fp(rng, (n, B), dev) if F is Fp252
         else _rand_gl(rng, (n, B * F.NLIMBS // 2), dev).reshape(
             n, B, F.NLIMBS))
    want = {inverse: ntt(F, x, inverse) for inverse in (False, True)}
    for D in (4, 8):
        mesh = make_mesh(D, device=dev)
        for inverse in (False, True):
            got = dist.gather(dist.dist_ntt(F, mesh, x, inverse), mesh, dev)
            assert torch.equal(got, want[inverse]), (D, inverse)
        before = dist.NTT_CALLS
        with runtime.mesh_scope(mesh):
            assert torch.equal(ntt(F, x), want[False])
        assert dist.NTT_CALLS == before + 1


# -- the Goldilocks / GF(p^3) route of phases 4 to 6 ------------------------

def _gl_field(name):
    from sandstorm_tpu_torch.fields.gl3 import GL3
    return {"goldilocks": GL, "gl3": GL3}[name]


def _rand_gl_elems(rng, n, F, dev):
    """n random canonical elements of F ([n, L]: GL or GF(p^3))."""
    return _rand_gl(rng, (n, F.NLIMBS // 2), dev).reshape(n, F.NLIMBS)


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("n", SCAN_SIZES)
def test_gl_scan_and_batch_inv_match_plain(dev, name, n):
    """gl_scan_mul (both directions) and gl_batch_inv of one array against
    their plain versions on the card, one and three columns; a zero in a
    column zeroes that column's inverses only."""
    F = _gl_field(name)
    add, sub, mul = gl_cuda.plain_ops(F.NLIMBS)
    rng = np.random.default_rng(n + F.NLIMBS)
    for C in (1, 3):
        x = _rand_gl_elems(rng, n * C, F, dev).reshape(n, C, F.NLIMBS)
        for reverse in (False, True):
            assert torch.equal(prefix_mul(F, x, reverse),
                               prefix_scan(mul, x, reverse)), (C, reverse)
        (got,) = batch_inv_many(F, [x])
        assert torch.equal(got, gl_cuda.batch_inv_plain(x))
        x[n // 2, C - 1] = 0
        (got,) = batch_inv_many(F, [x])
        assert torch.equal(got, gl_cuda.batch_inv_plain(x))
        assert not got[:, C - 1].any()


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_gl_batch_inv_segments_and_repeats(dev, name):
    """One gl_batch_inv call over segments of mixed lengths and widths with
    zeros in two of them, each equal to batch_inv_plain of it alone; then
    10 repeats of the scan and the inversion at 2^20 rows (a look-back
    race in the scan, or a race between the inversion's tiles, shows as a
    rare wrong row) equal to the first call and to the plain versions."""
    F = _gl_field(name)
    mul = gl_cuda.plain_ops(F.NLIMBS)[2]
    rng = np.random.default_rng(F.NLIMBS)
    shapes = [(1,), (2, 3), (257,), (5000, 2), ((1 << 18) + 5,), (0,)]
    xs = [_rand_gl_elems(rng, int(np.prod(s)), F, dev).reshape(
        s + (F.NLIMBS,)) for s in shapes]
    xs[3][4999, 0] = 0
    xs[2][0] = 0
    got = batch_inv_many(F, xs)
    for x, g in zip(xs, got):
        assert g.shape == x.shape
        assert torch.equal(g, gl_cuda.batch_inv_plain(x))
    assert not got[3][:, 0].any() and got[3][:, 1].any(dim=-1).all()
    assert not got[2].any()
    x = _rand_gl_elems(rng, 1 << 20, F, dev)
    x[0] = 1
    first = [prefix_mul(F, x), prefix_mul(F, x, True),
             batch_inv_many(F, [x])[0]]
    assert torch.equal(first[0], prefix_scan(mul, x))
    assert torch.equal(first[1], prefix_scan(mul, x, True))
    assert torch.equal(first[2], gl_cuda.batch_inv_plain(x))
    for _ in range(10):
        assert torch.equal(prefix_mul(F, x), first[0])
        assert torch.equal(prefix_mul(F, x, True), first[1])
        assert torch.equal(batch_inv_many(F, [x])[0], first[2])


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("C", [1, 3, 20, 40])
def test_gl_scan_tiles_match_plain(dev, monkeypatch, name, C):
    """gl_scan_mul on its tiles (gl_cuda.scan_tiles) against prefix_scan of
    the plain multiply on the card, both directions, with a zero
    mid-column: at n = R - 1, R, R + 1 and 3R + 5 around the rows R of a
    chained call's tile (for C > 1 these fit one tile a group), and past a
    tile's elements E, n = E + 1 and 2E + R + 5, where a group's tiles
    chain by look-back (C = 40 wider than a tile's columns); every word
    p - 1 (chip_smoke's top_field) at E + 1; [1024, C] (C = 20: the
    opener's power tables), whose groups fit one tile each: one launch,
    counted once, given no look-back state (the C entry memsets only a
    chained call's, and refuses one without it); a chained call's is
    given."""
    from sandstorm_tpu_torch import _native
    F = _gl_field(name)
    L = F.NLIMBS
    mul = gl_cuda.plain_ops(L)[2]
    rng = np.random.default_rng(C + L)
    R = gl_cuda.scan_tiles(1 << 30, C, L)[2]
    E = gl_cuda.SCAN_THREADS * gl_cuda.SCAN_RUN[L]
    for n in (R - 1, R, R + 1, 3 * R + 5, E + 1, 2 * E + R + 5, 1024):
        x = _rand_gl_elems(rng, n * C, F, dev).reshape(n, C, L)
        x[n // 2, C - 1] = 0
        for reverse in (False, True):
            assert torch.equal(prefix_mul(F, x, reverse),
                               prefix_scan(mul, x, reverse)), (n, reverse)
    top = torch.tensor([0, -1], dtype=torch.int32,
                       device=dev).repeat(E + 1, C, L // 2)
    for reverse in (False, True):
        assert torch.equal(prefix_mul(F, top, reverse),
                           prefix_scan(mul, top, reverse))
    assert gl_cuda.scan_tiles(1024, C, L)[3] == 1
    calls, launch = [], _native.launch
    monkeypatch.setattr(_native, "launch", lambda name, device, *args:
                        calls.append((name, args[-1]))
                        or launch(name, device, *args))
    before = _native.LAUNCHES["gl_scan_mul"]
    prefix_mul(F, x)
    assert _native.LAUNCHES["gl_scan_mul"] == before + 1
    assert calls == [("gl_scan_mul", None)]
    chained = _rand_gl_elems(rng, (E + 1) * C, F, dev).reshape(E + 1, C, L)
    assert gl_cuda.scan_tiles(E + 1, C, L)[3] > 1
    prefix_mul(F, chained)
    assert len(calls) == 2 and calls[1][1] is not None


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_gl_scan_repeats_at_2_20(dev, name):
    """10 repeats of gl_scan_mul at 2^20 rows in one column and in three,
    both directions, each equal to the first and to the plain version: a
    race in the look-back shows as a rare wrong row."""
    F = _gl_field(name)
    mul = gl_cuda.plain_ops(F.NLIMBS)[2]
    rng = np.random.default_rng(20 + F.NLIMBS)
    for C in (1, 3):
        x = _rand_gl_elems(rng, C << 20, F, dev).reshape(
            1 << 20, C, F.NLIMBS)
        for reverse in (False, True):
            want = prefix_scan(mul, x, reverse)
            for _ in range(10):
                assert torch.equal(prefix_mul(F, x, reverse), want)


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("n,blowup", [(64, 2), (32, 4), (1 << 10, 2)])
def test_gl_deep_compose_matches_plain(dev, name, n, blowup):
    """gl_deep_compose (one batch_inv_many of u and v, then the kernel) on
    the card against its plain version _deep_shifted and the windowed
    _deep_compose on the CPU, with offsets below 0, of a trace length and
    beyond, and a point of 20 terms."""
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.stark import prover
    F = _gl_field(name)
    prng = random.Random(n + blowup)
    rng = np.random.default_rng(n)
    targs = [(0, 0), (1, -1), (2, -3), (0, n), (1, n + 5), (2, 2 * n - 1),
             (0, -n - 2), (1, 3)] + [(c, 7) for c in range(20)]
    N = n * blowup
    stack = _rand_gl_elems(rng, N * 22, F, dev).reshape(N, 22, F.NLIMBS)
    cols = dict(enumerate(stack[:, :20].unbind(1)))
    comp = list(stack[:, 20:].unbind(1))
    tv = [prng.randrange(F.MODULUS) for _ in targs]
    cv = [prng.randrange(F.MODULUS) for _ in range(2)]
    z, alpha = prng.randrange(F.MODULUS), prng.randrange(F.MODULUS)
    g = F.root_of_unity_int(n)
    before = _native.LAUNCHES["gl_deep_compose"]
    got = prover.deep_compose(F, prover._DomainCache(F, N, F.GENERATOR, dev),
                              targs, cols, comp, tv, cv, z, g, n, alpha)
    assert _native.LAUNCHES["gl_deep_compose"] - before == 1
    cpu = torch.device("cpu")
    args = (targs, {c: v.cpu() for c, v in cols.items()},
            [v.cpu() for v in comp], tv, cv, z, g, n, alpha)
    dom = prover._DomainCache(F, N, F.GENERATOR, cpu)
    assert torch.equal(got.cpu(), prover._deep_shifted(F, dom, *args))
    assert torch.equal(got.cpu(), prover._deep_compose(F, dom, *args))


def _base_embedded(x):
    """x with the upper coordinates of each GF(p^3) element zeroed: a
    base-field value, as a GF(p^3) prove's base columns hold them."""
    x = x.clone()
    if x.shape[-1] == 6:
        x[..., 2:] = 0
    return x


def _p_minus_1(F, shape, base, dev):
    """Elements whose every coordinate is p - 1 (base: c0 = p - 1, the
    others 0), the largest canonical words."""
    x = torch.tensor([0, -1], dtype=torch.int32).repeat(F.NLIMBS // 2)
    x = x.expand(tuple(shape) + (F.NLIMBS,)).contiguous().to(dev)
    return _base_embedded(x) if base else x


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("n,C,K", [(16, 1, 1), (1 << 10, 8, 20),
                                   (1 << 12, 5, 3)])
def test_gl_open_dense_matches_plain(dev, name, n, C, K):
    """gl_open_pairs (one launch) at every (point, column) pair against
    open_dense_plain on the CPU, for one column at one point, 8 columns
    at 20 points and a ragged column group: the leading half of the
    columns base-field values read as one word (strided views of one
    [n, C, L] tensor, as a prove's coefficient columns are), then every
    word p - 1; and a list of pairs in any order with a repeat."""
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.stark import openings
    F = _gl_field(name)
    prng = random.Random(n + C)
    rng = np.random.default_rng(K)
    nbase = C // 2
    stack = _rand_gl_elems(rng, C * n, F, dev).reshape(n, C, F.NLIMBS)
    stack[:, :nbase] = _base_embedded(stack[:, :nbase])
    cols = list(stack.unbind(1))
    pts = [prng.randrange(F.MODULUS) for _ in range(K)]
    lo, hi = openings._power_tables(F, pts, n, dev)
    kidx = [k for k in range(K) for _ in range(C)]
    cidx = [c for _ in range(K) for c in range(C)]
    before = _native.LAUNCHES["gl_open_pairs"]
    got = openings.open_pairs_gl(F, cols, lo, hi, kidx, cidx, nbase)
    assert _native.LAUNCHES["gl_open_pairs"] - before == 1
    want = openings.open_dense_plain(F, stack.transpose(0, 1).cpu(),
                                     lo.cpu(), hi.cpu())
    assert torch.equal(got.cpu(), want.reshape(K * C, F.NLIMBS))
    pairs = [(K - 1, C - 1), (0, 0), (K - 1, 0), (0, C - 1), (0, 0)]
    got = openings.open_pairs_gl(F, cols, lo, hi, [k for k, _ in pairs],
                                 [c for _, c in pairs], nbase)
    assert torch.equal(got.cpu(), torch.stack([want[k, c]
                                               for k, c in pairs]))
    big = [_p_minus_1(F, (n,), c < nbase, dev) for c in range(C)]
    top = [_p_minus_1(F, t.shape[:2], False, dev) for t in (lo, hi)]
    got = openings.open_pairs_gl(F, big, *top, kidx, cidx, nbase)
    want = openings.open_dense_plain(F, torch.stack(big).cpu(),
                                     top[0].cpu(), top[1].cpu())
    assert torch.equal(got.cpu(), want.reshape(K * C, F.NLIMBS))


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("n,blowup", [(16, 4), (1 << 10, 2)])
@pytest.mark.parametrize("nbase", [0, 5])
def test_air_group_gl_kernels_match_the_interpreter(dev, name, n, blowup,
                                                    nbase):
    """The plain layout's group kernels rendered for GL and GF(p^3)
    (evaluate_lde_folded on the card, whole domain and in windows)
    against the plain interpreter on the CPU and the eager walk on the
    card; and a DAG with negative offsets, a pow and scalar subtrees with
    an inverse (group size 2).  With nbase = 5 the leading columns hold
    base-field values and are named base (the typed kernels read their c0
    word, as a prove's)."""
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.air import codegen
    from sandstorm_tpu_torch.air import expr as E
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.stark.prover import _DomainCache
    F = _gl_field(name)
    prng = random.Random(n)
    rng = np.random.default_rng(n)
    N = n * blowup
    t0, t1, tm = E.Trace(0, 0), E.Trace(1, 1), E.Trace(1, -3)
    small = [tm * t0 - E.Challenge(0),
             (E.Trace(0, -n) - tm.pow(5)) / (E.X - 5) + E.X.pow(N // 2),
             -tm * E.Challenge(0) * E.Challenge(0)
             - E.Constant(5) / E.Challenge(0)]
    cons = PlainAirConfig.constraints(n, F.MODULUS, F.root_of_unity_int(n),
                                      base_modulus=GL.MODULUS)
    for exprs, gs in ((cons, 8), (small, 2)):
        keys = [nd.key for nd in E.walk(exprs)]
        ncols = 1 + max(k[1] for k in keys if k[0] == "trace")
        alpha = F.s(prng.randrange(F.MODULUS))
        coeffs = [alpha ** i for i in range(len(exprs))]
        out = {}
        for d in (dev, torch.device("cpu")):
            stack = _rand_gl_elems(np.random.default_rng(n), N * ncols, F,
                                   d).reshape(N, ncols, F.NLIMBS)
            base = range(min(nbase, ncols - 1))
            stack[:, :len(base)] = _base_embedded(stack[:, :len(base)])
            dom = _DomainCache(F, N, F.GENERATOR, d)
            sc = random.Random(1)

            def scalars(kind):
                count = 1 + max((k[1] for k in keys if k[0] == kind),
                                default=-1)
                return [F.encode_int(sc.randrange(F.MODULUS), d)
                        for _ in range(count)]

            ctx = E.LdeContext(F, dict(enumerate(stack.unbind(1))), blowup,
                               dom.domain, dom.x_pow,
                               challenges=scalars("challenge"),
                               hints=scalars("hint"))
            before = _native.LAUNCHES[codegen.COUNTER[F.NAME]]
            out[d.type] = E.evaluate_lde_folded(exprs, ctx, N, coeffs,
                                                group_size=gs, base_cols=base)
            if d.type == "cuda":
                assert _native.LAUNCHES[codegen.COUNTER[F.NAME]] - before \
                    == -(-len(exprs) // gs)
                assert torch.equal(E.evaluate_lde_folded(
                    exprs, ctx, N, coeffs, group_size=gs, chunk_size=N // 4,
                    base_cols=base), out["cuda"])
                enc = F.encode_ints(coeffs, d)

                def fold(acc, v, i):
                    t = F.mul(v, enc[i])
                    return t if acc is None else F.add(acc, t)

                assert torch.equal(E.evaluate_lde(exprs, ctx, N, fold=fold),
                                   out["cuda"])
        assert torch.equal(out["cuda"].cpu(), out["cpu"])


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_air_group_gl_at_p_minus_1(dev, name):
    """The plain layout's typed group kernels with every table word, scalar
    and fold coefficient p - 1 (a base table's c0 p - 1 and its upper
    coordinates 0), the largest products and sums the folds' unreduced
    accumulators take, against the plain interpreter of the same plan on
    the CPU."""
    from sandstorm_tpu_torch.air import codegen
    from sandstorm_tpu_torch.air.expr import _fold_run
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    F = _gl_field(name)
    n, N = 64, 128
    cons = PlainAirConfig.constraints(n, F.MODULUS, F.root_of_unity_int(n),
                                      base_modulus=GL.MODULUS)
    plan = codegen.lower(cons, N, [], 8, F.NAME, range(5))
    out = {}
    for d in (dev, torch.device("cpu")):
        tables = [_p_minus_1(F, (N,), t not in plan.ext_tables, d)
                  for t in range(len(plan.tables))]
        scalars = torch.cat([_p_minus_1(F, (1,), r not in plan.ext_scalars, d)
                             for r in range(plan.scalar_rows)])
        res = torch.empty((N, F.NLIMBS), dtype=torch.int32, device=d)
        out[d.type] = _fold_run(F, plan, tables, scalars, 2, res).cpu()
    assert torch.equal(out["cuda"], out["cpu"])


@pytest.mark.parametrize("n", [1, 255, 1 << 16])
def test_gl3_mul_chain_matches_plain(dev, n):
    """gl3_mul (goldilocks.cuh's lazily reduced schoolbook) chained five
    times equals the plain chain, on random elements and on p - 1 in
    every coordinate."""
    from sandstorm_tpu_torch.fields.gl3 import GL3
    rng = np.random.default_rng(n)
    for a, b in ((_rand_gl_elems(rng, n, GL3, dev),
                  _rand_gl_elems(rng, n, GL3, dev)),
                 (_p_minus_1(GL3, (n,), False, dev),) * 2):
        got, want = a, a.cpu()
        for _ in range(5):
            got = gl_cuda.gl3_mul(got, b)
            want = gl_cuda.gl3_mul_plain(want, b.cpu())
        assert torch.equal(got.cpu(), want)


# -- gl_batch_inv (one launch, tile-local inverses) and gl_deep_compose ------
# (base-field terms, unreduced sums, tables in shared memory)

def _no_sync(fn):
    """fn() under the sync debug mode: a device-to-host copy or a
    synchronize inside it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


# around a tile: 2048 rows a GF(p^3) tile of one column, 4096 a Goldilocks
# one (gl_cuda.INV_ROWS); a 3-column segment's tiles take a third as many
GL_TILE_SIZES = [2047, 2048, 2049, 4095, 4096, 4097, 682 * 3 + 1,
                 1365 * 2 + 1, (1 << 16) + 3]


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("n", GL_TILE_SIZES)
def test_gl_batch_inv_around_tiles(dev, name, n):
    """One gl_batch_inv call over [n], [n, 3] and [5, 2] arrays: one
    launch, no synchronize (the sync debug mode raises on one), each array
    equal to batch_inv_plain of it alone."""
    from sandstorm_tpu_torch import _native
    F = _gl_field(name)
    rng = np.random.default_rng(n + F.NLIMBS)
    xs = [_rand_gl_elems(rng, n, F, dev),
          _rand_gl_elems(rng, 3 * n, F, dev).reshape(n, 3, F.NLIMBS),
          _rand_gl_elems(rng, 10, F, dev).reshape(5, 2, F.NLIMBS)]
    before = _native.LAUNCHES["gl_batch_inv"]
    got = _no_sync(lambda: batch_inv_many(F, xs))
    assert _native.LAUNCHES["gl_batch_inv"] - before == 1
    for x, g in zip(xs, got):
        assert torch.equal(g, gl_cuda.batch_inv_plain(x))


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_gl_batch_inv_zero_in_one_tile_of_many(dev, name):
    """[2^20, 3] with a single zero in the middle column, in one tile of
    hundreds: that column comes out all zero in every tile (the last
    block's pass), its neighbours equal their plain inverses, the same in
    each of 10 repeats (a race between a tile's flag and the zeroing shows
    as a stray row); then with zeros in two tiles of two columns."""
    F = _gl_field(name)
    rng = np.random.default_rng(7 + F.NLIMBS)
    x = _rand_gl_elems(rng, 3 << 20, F, dev).reshape(1 << 20, 3, F.NLIMBS)
    x[(1 << 19) + 5, 1] = 0
    want = gl_cuda.batch_inv_plain(x)
    assert not want[:, 1].any()
    assert want[:, 0].any(dim=-1).all() and want[:, 2].any(dim=-1).all()
    for _ in range(10):
        assert torch.equal(batch_inv_many(F, [x])[0], want)
    x[3, 0] = 0
    x[(1 << 20) - 1, 0] = 0
    (got,) = batch_inv_many(F, [x])
    assert not got[:, :2].any() and torch.equal(got[:, 2], want[:, 2])


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_gl_batch_inv_wide_and_many_segments(dev, name):
    """Segments wider than a tile takes (20 and 40 columns: column groups
    of 16 or 8) and 40 arrays in one call (a launch of INV_MAX_SEGS
    segments, then one of 8), zeros in two of them: each equals its plain
    version."""
    from sandstorm_tpu_torch import _native
    F = _gl_field(name)
    rng = np.random.default_rng(40 + F.NLIMBS)
    shapes = [(300, 20), (3, 40)] + [(17 * k + 1,) for k in range(38)]
    xs = [_rand_gl_elems(rng, int(np.prod(s)), F, dev).reshape(
        s + (F.NLIMBS,)) for s in shapes]
    xs[0][299, 13] = 0
    xs[5][0] = 0
    before = _native.LAUNCHES["gl_batch_inv"]
    got = batch_inv_many(F, xs)
    assert _native.LAUNCHES["gl_batch_inv"] - before == 2
    for x, g in zip(xs, got):
        assert torch.equal(g, gl_cuda.batch_inv_plain(x))
    assert not got[0][:, 13].any() and not got[5].any()


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_gl_batch_inv_at_p_minus_1(dev, name):
    """Every word p - 1 (the largest canonical coordinates) over
    [2^16 + 3, 3] and [4097]: equal to the plain version."""
    F = _gl_field(name)
    for shape in (((1 << 16) + 3, 3), (4097,)):
        x = _p_minus_1(F, shape, False, dev)
        assert torch.equal(batch_inv_many(F, [x])[0],
                           gl_cuda.batch_inv_plain(x))


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_gl_device_inverse_on_edge_values(dev, name):
    """The device inversion on the card (gl::inv, of the norm over
    GF(p^3): gl3::norm): a [1, K] array is K tiles of one row, each
    column's inverse the device's inversion of its element, against the
    field's host inverse (GL.inv: pow(x, p - 2, p); GL3.inv: Fq3S.inv)
    at 0, 1, p - 1, coordinates at p - 1 and near 2^64, and random
    values."""
    F = _gl_field(name)
    P = GL.MODULUS
    vals = [0, 1, 2, P - 1, P - 2, 1 << 63, (1 << 32) - 1, (P - 1) // 2]
    if F.NLIMBS == 6:
        vals += [P, P * P, F.MODULUS - 1, F.MODULUS - 2, (P - 1) * (1 + P),
                 (P - 1) * P * P]
    prng = random.Random(F.NLIMBS)
    vals += [prng.randrange(F.MODULUS) for _ in range(64 - len(vals))]
    x = F.encode_ints(vals, dev).reshape(1, len(vals), F.NLIMBS)
    (got,) = batch_inv_many(F, [x])
    assert torch.equal(got.reshape(len(vals), F.NLIMBS).cpu(),
                       F.inv(x.reshape(len(vals), F.NLIMBS).cpu()))


class _PlainGL:
    """A Goldilocks field (L = 2) or GF(p^3) (L = 6) whose operations are
    the plain versions, for deep_launch_plain on the card."""

    def __init__(self, L):
        self.add, self.sub, self.mul = gl_cuda.plain_ops(L)


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
@pytest.mark.parametrize("n,blowup", [(64, 2), (1 << 10, 2)])
def test_gl_deep_compose_base_columns(dev, name, n, blowup):
    """gl_deep_compose at the plain layout's trace arguments (20 points,
    50 terms) with the 5 main columns base-field values and named base
    (nbase 5, read as their c0 word): equal to _deep_shifted and
    _deep_compose on the CPU, and to the kernel's contract in plain ops on
    the card (deep_launch_plain); with every column word p - 1 (a base
    column's c0) equal to its contract; a column named base whose upper
    coordinates are not zero is refused."""
    from sandstorm_tpu_torch.air.expr import trace_arguments
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.stark import prover
    F = _gl_field(name)
    L = F.NLIMBS
    prng = random.Random(n + L)
    rng = np.random.default_rng(n)
    g = F.root_of_unity_int(n)
    targs = trace_arguments(PlainAirConfig.constraints(
        n, F.MODULUS, g, base_modulus=GL.MODULUS))
    nb = PlainAirConfig.NUM_BASE_COLUMNS
    ncols = 1 + max(c for c, _ in targs)
    N = n * blowup
    stack = _rand_gl_elems(rng, N * (ncols + 2), F, dev).reshape(
        N, ncols + 2, L)
    stack[:, :nb] = _base_embedded(stack[:, :nb])
    cols = dict(enumerate(stack[:, :ncols].unbind(1)))
    comp = list(stack[:, ncols:].unbind(1))
    tv = [prng.randrange(F.MODULUS) for _ in targs]
    cv = [prng.randrange(F.MODULUS) for _ in range(2)]
    z, alpha = prng.randrange(F.MODULUS), prng.randrange(F.MODULUS)
    args = (targs, cols, comp, tv, cv, z, g, n, alpha)
    dom = prover._DomainCache(F, N, F.GENERATOR, dev)
    got = prover.deep_compose(F, dom, *args, base_cols=range(nb))
    prep = prover.deep_prepare(F, dom, *args, base_cols=range(nb))
    assert prep["nbase"] == nb and (prep["points"], prep["terms"]) == (20, 50)
    assert torch.equal(prover.deep_launch(prep), got)
    assert torch.equal(prover.deep_launch_plain(_PlainGL(L), prep), got)
    cpu = torch.device("cpu")
    cargs = (targs, {c: v.cpu() for c, v in cols.items()},
             [v.cpu() for v in comp], tv, cv, z, g, n, alpha)
    cdom = prover._DomainCache(F, N, F.GENERATOR, cpu)
    assert torch.equal(got.cpu(), prover._deep_shifted(F, cdom, *cargs))
    assert torch.equal(got.cpu(), prover._deep_compose(F, cdom, *cargs))
    top = torch.stack([_p_minus_1(F, (N,), c < nb, dev)
                       for c in range(ncols + 2)], 1)
    targs_top = (targs, dict(enumerate(top[:, :ncols].unbind(1))),
                 list(top[:, ncols:].unbind(1))) + args[3:]
    tprep = prover.deep_prepare(F, dom, *targs_top, base_cols=range(nb))
    assert torch.equal(prover.deep_launch(tprep),
                       prover.deep_launch_plain(_PlainGL(L), tprep))
    if L == 6:
        with pytest.raises(ValueError, match="nonzero upper"):
            prover.deep_compose(F, dom, *args, base_cols=range(nb + 1))


# -- the FRI fold, the coset scale and pad, the affine pair scan -------------

def _any_field(name):
    return Fp252 if name == "fp252" else _gl_field(name)


def _rand_elems(rng, n, F, dev):
    return (_rand_fp(rng, (n,), dev) if F.NLIMBS == 8
            else _rand_gl_elems(rng, n, F, dev))


def _top(F, n, dev):
    """n elements p - 1 (every coordinate p - 1 over GF(p^3))."""
    return F.encode_ints([F.MODULUS - 1] * n, dev)


@pytest.mark.parametrize("name", ["fp252", "goldilocks", "gl3"])
@pytest.mark.parametrize("f", [2, 4, 8, 16])
def test_fri_fold_matches_plain(dev, name, f):
    """One fri_fold launch a fold against the plain chain on the CPU, bit
    for bit: layers of 2^6 and 2^9 rows (fewer outputs than a block),
    2^12 and 2^16, random values with p - 1, 0 and 1 among them, and a
    layer of p - 1 alone; one launch a call."""
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.stark.fri import fri_fold_device
    F = _any_field(name)
    rng = np.random.default_rng(f + F.NLIMBS)
    prng = random.Random(f)
    entry = _native.FIELD_KERNELS[F.NLIMBS]["fold"]
    for N in (1 << 6, 1 << 9, 1 << 12, 1 << 16):
        coset = pow(F.GENERATOR, prng.randrange(1, 1 << 20),
                    F.BASE_MODULUS)
        beta = prng.randrange(F.MODULUS)
        x = _rand_elems(rng, N, F, dev)
        x[:3] = F.encode_ints([F.MODULUS - 1, 0, 1], dev)
        for v in (x, _top(F, N, dev)):
            before = _native.LAUNCHES[entry]
            got = fri_fold_device(F, v, coset, N, f, beta)
            assert _native.LAUNCHES[entry] - before == 1
            want = fri_fold_device(F, v.cpu(), coset, N, f, beta)
            assert torch.equal(got.cpu(), want), (N, f)


@pytest.mark.parametrize("name", ["fp252", "goldilocks", "gl3"])
def test_scale_pad_matches_plain(dev, name):
    """scale_pad on the card against its plain version on the CPU: the coset
    powers and a scalar, no pad and a pad to 2n and 4n rows, on a
    contiguous [n, C, L] array, on a transposed view (intt's columns), on
    one column, at p - 1; the pad rows canonical zero."""
    from sandstorm_tpu_torch.ntt import scale_pad
    F = _any_field(name)
    L = F.NLIMBS
    rng = np.random.default_rng(L + 40)
    p = F.BASE_MODULUS
    for n, C in ((1, 1), (255, 3), (1 << 12, 5), (1 << 16, 1)):
        base = _rand_elems(rng, n * C, F, dev).reshape(C, n, L)
        views = [base.transpose(0, 1), base.transpose(0, 1).contiguous(),
                 _top(F, n * C, dev).reshape(n, C, L)]
        for x in views:
            for N in (n, 2 * n, 4 * n):
                for kw in ({"coset": pow(F.GENERATOR, 3, p)},
                           {"factor": pow(n, -1, p)}):
                    got = scale_pad(F, x, N, **kw)
                    assert got.is_contiguous() and got.shape == (N, C, L)
                    want = scale_pad(F, x.cpu(), N, **kw)
                    assert torch.equal(got.cpu(), want), (n, C, N, kw)
                    assert not got[n:].any()


# affine maps around a tile: runs of 1 row up to a tile of 256 rows an
# SM, several tiles at 3 x 256 + 5; 2^18 - 1, starknet's length (128 tiles
# of runs of 8, one wave)
AFFINE_SIZES = [1, 2, 37, 255, 256, 257, 3 * 256 + 5, (1 << 18) - 1]


def _affine_want(a, b):
    """The aggregate column by python ints: 1, then acc = acc a_k + b_k."""
    P = Fp252.MODULUS
    acc, out = 1, [1]
    for x, y in zip(Fp252.decode_ints(a), Fp252.decode_ints(b)):
        acc = (acc * x + y) % P
        out.append(acc)
    return Fp252.encode_ints(out, a.device)


@pytest.mark.parametrize("n", AFFINE_SIZES)
def test_affine_scan_matches_plain(dev, n):
    """fp252_affine_scan (one launch) against the maps composed by python
    ints and, below 2^12 rows, against affine_scan_plain on the CPU; p - 1
    maps; at the widest length 10 repeats equal to the first (a torn read
    of a published 64-byte pair shows as a rare wrong row)."""
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.fields.scan import affine_scan, affine_scan_plain
    rng = np.random.default_rng(n + 3)
    a, b = _rand_fp(rng, (n,), dev), _rand_fp(rng, (n,), dev)
    a[0] = _top(Fp252, 1, dev)[0]
    b[-1] = _top(Fp252, 1, dev)[0]
    before = _native.LAUNCHES["fp252_affine_scan"]
    got = affine_scan(Fp252, a, b)
    assert _native.LAUNCHES["fp252_affine_scan"] - before == 1
    assert torch.equal(got, _affine_want(a, b))
    if n < 1 << 12:
        assert torch.equal(got.cpu(), affine_scan_plain(Fp252, a.cpu(),
                                                        b.cpu()))
    top = _top(Fp252, n, dev)
    assert torch.equal(affine_scan(Fp252, top, top), _affine_want(top, top))
    if n == AFFINE_SIZES[-1]:
        for _ in range(10):
            assert torch.equal(affine_scan(Fp252, a, b), got)


def _fold_setup(F, N, f, seed, dev):
    """A fold's inputs on the card: a layer of N random values (p - 1, 0
    and 1 first), the transform field's table w^-i and the stages'
    scalars (numpy words)."""
    from sandstorm_tpu_torch.ntt import powers_dev
    from sandstorm_tpu_torch.stark.fri import fold_scalars
    rng = np.random.default_rng(seed)
    x = _rand_elems(rng, N, F, dev)
    x[:3] = F.encode_ints([F.MODULUS - 1, 0, 1], dev)[:N]
    T = ntt_cuda.transform_field(F)
    w_inv = pow(F.root_of_unity_int(N), -1, F.BASE_MODULUS)
    xinv = powers_dev(T, w_inv, N // 2, dev)
    coset = pow(F.GENERATOR, 3 + seed, F.BASE_MODULUS)
    beta = (F.MODULUS - 1) // (seed + 2)
    return x, xinv, F.encode_ints_np(fold_scalars(F, coset, f, beta)), \
        coset, beta


def _fold_plain_cpu(F, x, N2, f, coset, beta):
    """The fold's plain chain on the CPU of a layer x whose table is the
    domain of N2 rows (x may hold fewer: a multiple of f)."""
    from sandstorm_tpu_torch.ntt import powers_dev
    from sandstorm_tpu_torch.stark.fri import fold_scalars, fri_fold_plain
    cpu = torch.device("cpu")
    w_inv = pow(F.root_of_unity_int(N2), -1, F.BASE_MODULUS)
    return fri_fold_plain(F, x.cpu(), powers_dev(F, w_inv, N2 // 2, cpu),
                          [F.encode_int(v, cpu)
                           for v in fold_scalars(F, coset, f, beta)])


@pytest.mark.parametrize("name", ["fp252", "goldilocks", "gl3"])
@pytest.mark.parametrize("f", [2, 4, 8, 16])
def test_fri_fold_every_mode_matches_plain(dev, name, f):
    """Each form the fold's entry picks (field_cuda.fold_lanes: a thread an
    output past FOLD_LANE_THREADS outputs an SM, else up to f / 2 lanes an
    output) against the plain chain on the CPU, at 1 and 37 outputs (a
    ragged warp) and on both sides of every crossover of the card, on a
    layer led by p - 1, 0 and 1 and on a layer of p - 1."""
    from sandstorm_tpu_torch.fields import field_cuda
    F = _any_field(name)
    cap = field_cuda.FOLD_LANE_THREADS * fp252_cuda.sm_count(dev)
    sizes = [1, 37] + [m for lg in range(f.bit_length() - 1)
                       for m in (cap >> lg, (cap >> lg) + 1)]
    forms = set()
    for M in sizes:
        N = M * f
        N2 = 1 << (N - 1).bit_length()
        x, xinv, sc, coset, beta = _fold_setup(F, N2, f, M % 7, dev)
        forms.add(field_cuda.fold_lanes(M, f, fp252_cuda.sm_count(dev)))
        for v in (x[:N], _top(F, N, dev)):
            got = field_cuda.fold_launch(v, xinv, sc)
            assert torch.equal(got.cpu(), _fold_plain_cpu(F, v, N2, f, coset,
                                                          beta)), (M, N)
    assert forms == set(range(f.bit_length() - 1))


def test_fri_fold_default_mode_at_the_crossover(dev):
    """fri_fold_device at f = 8 (one launch) at 2^12 to 2^17 outputs over
    each field, across the entry's crossovers from 4 lanes an output to a
    thread an output, against the plain chain on the CPU."""
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.fields.fp252 import Fp252 as F8
    from sandstorm_tpu_torch.fields.gl3 import GL3
    from sandstorm_tpu_torch.stark.fri import fri_fold_device
    for F in (F8, GL, GL3):
        entry = _native.FIELD_KERNELS[F.NLIMBS]["fold"]
        for M in (1 << 12, 1 << 13, 1 << 15, 1 << 16, 1 << 17):
            x, xinv, sc, coset, beta = _fold_setup(F, M * 8, 8, 4, dev)
            before = _native.LAUNCHES[entry]
            got = fri_fold_device(F, x, coset, M * 8, 8, beta)
            assert _native.LAUNCHES[entry] - before == 1
            assert torch.equal(got.cpu(), _fold_plain_cpu(
                F, x, M * 8, 8, coset, beta)), (F.NAME, M)


def test_affine_scan_runs_and_look_back_steps(dev):
    """fp252_affine_scan at the longest length of each run of
    fp252_cuda.AFFINE_RUNS (a tile an SM) and at 5000 maps; one tile more
    than the SMs; 300 x 2048 + 7 maps (301 tiles of runs of 8: the
    look-back's second step), p - 1 maps there, then 10 repeats equal to
    the first (a torn read of a published aggregate shows as a rare wrong
    row)."""
    rng = np.random.default_rng(77)
    sms = fp252_cuda.sm_count(dev)
    T = fp252_cuda.SCAN_THREADS
    sizes = [5000] + [sms * T * r for r in fp252_cuda.AFFINE_RUNS] \
        + [sms * T * 8 + 1]
    runs = set()
    for n in sizes:
        runs.add(fp252_cuda.affine_plan(n, sms)[0])
        a, b = _rand_fp(rng, (n,), dev), _rand_fp(rng, (n,), dev)
        assert torch.equal(fp252_cuda.affine_launch(a, b),
                           _affine_want(a, b)), n
    assert runs == set(fp252_cuda.AFFINE_RUNS)
    n = 300 * T * 8 + 7
    assert fp252_cuda.affine_plan(n, sms) == (8, 301)
    a, b = _rand_fp(rng, (n,), dev), _rand_fp(rng, (n,), dev)
    got = fp252_cuda.affine_launch(a, b)
    assert torch.equal(got, _affine_want(a, b))
    top = _top(Fp252, n, dev)
    assert torch.equal(fp252_cuda.affine_launch(top, top),
                       _affine_want(top, top))
    for _ in range(10):
        assert torch.equal(fp252_cuda.affine_launch(a, b), got)


def test_new_entries_raise_without_their_kernels(dev, monkeypatch):
    """With the kernel library unavailable, a CUDA tensor through the fold,
    the scale and pad or the affine scan raises: no torch chain computes
    it instead."""
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.fields.scan import affine_scan
    from sandstorm_tpu_torch.ntt import scale_pad
    from sandstorm_tpu_torch.stark.fri import fri_fold_device
    rng = np.random.default_rng(5)
    x = _rand_fp(rng, (64,), dev)
    g = _rand_gl_elems(rng, 64, GL, dev)
    fri_fold_device(Fp252, x, Fp252.GENERATOR, 64, 8, 3)   # tables built

    def unavailable():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "lib", unavailable)
    for call in (lambda: fri_fold_device(Fp252, x, Fp252.GENERATOR, 64, 8, 3),
                 lambda: fri_fold_device(GL, g, GL.GENERATOR, 64, 4, 3),
                 lambda: scale_pad(Fp252, x, 128, factor=3),
                 lambda: scale_pad(GL, g, 64, factor=5),
                 lambda: affine_scan(Fp252, x, x)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()


@pytest.mark.parametrize("name", ["fp252", "goldilocks"])
def test_staged_uploads_back_to_back(dev, name):
    """Two uploads of 7 x 2^20 canonical columns, both queued behind a
    second of device sleep so that every copy of the first is still in
    flight when the second stages; the host rewrites the columns in place
    between them.  Each result equals its words uploaded whole, the second
    reuses the first's pinned block, and h2d_pinned_bytes counts exactly
    the columns' bytes."""
    from sandstorm_tpu_torch import telemetry
    from sandstorm_tpu_torch.fields import staging
    F = {"fp252": Fp252, "goldilocks": GL}[name]
    rng = np.random.default_rng(24)
    k, n = 7, 1 << 20

    def canonical():
        c = np.zeros((k, n, 4), dtype=np.uint64)
        if F is Fp252:
            c[...] = rng.integers(0, 1 << 64, size=c.shape, dtype=np.uint64)
            c[..., 3] &= np.uint64((1 << 59) - 1)
        else:
            c[..., 0] = rng.integers(0, gl_cuda.P, size=(k, n),
                                     dtype=np.uint64)
        return c

    def whole(words):
        if F is Fp252:
            return Fp252.to_mont(torch.from_numpy(
                words.view(np.int32).copy()).to(dev))
        return torch.from_numpy(np.ascontiguousarray(words[..., 0])
                                .view(np.int32).reshape(k, n, 2)).to(dev)

    src = canonical()
    words = [src.copy(), canonical()]
    want = [whole(w) for w in words]
    torch.cuda.synchronize(dev)
    rid = telemetry.new_request()
    with telemetry.span("upload", request=rid):
        torch.cuda._sleep(2_000_000_000)
        first = F.encode_canonical_u64_many(list(src), dev, "base_columns")
        block = staging._PINNED.data_ptr()
        src[...] = words[1]
        second = F.encode_canonical_u64_many(list(src), dev, "base_columns")
        src[...] = 0
    assert staging._PINNED.data_ptr() == block
    for got, w in zip((first, second), want):
        assert len(got) == k and all(t._base is got[0]._base for t in got)
        assert torch.equal(got[0]._base, w)
    req = telemetry.get(rid)
    assert req.find("h2d.base_columns.wait")
    assert req.counts()["h2d_pinned_bytes"] == 2 * k * n * (
        32 if F is Fp252 else 8)

