"""The port's redesigned kernels against their plain versions on a CUDA
card, away from the main path's shapes: every leaf length, ragged batches,
four-step widths that no tile of adjacent transforms divides, pair lists
that split into several groups; the running-product scan and the
segmented batch inversion at ragged lengths, mixed segments with zeros
and 20 repeats (the look-back), DEEP at each layout's trace arguments and at wrapping and
negative offsets, the unreduced accumulate, each layout's generated
constraint-group kernels and groups of 1, 8 and 17 folds against their
interpreter; the four-step exchange NTT on a virtual mesh of the card.
chip_smoke.py holds the same kernels to
their plain versions at the main path's shapes.

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
from sandstorm_tpu_torch.fields.scan import prefix_scan  # noqa: E402
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
            assert torch.equal(fp252_cuda.scan_mul(x, reverse), want)


@pytest.mark.parametrize("n", SCAN_SIZES)
def test_batch_inv_matches_plain(dev, n):
    """fp252_batch_inv of one array against batch_inv_plain on the card, one
    and four columns; with a zero in one column, that column's inverses
    are all zero."""
    rng = np.random.default_rng(n + 1)
    for shape in ((n,), (n, 4)):
        x = _rand_fp(rng, shape, dev)
        (got,) = fp252_cuda.batch_inv_segments([x])
        assert torch.equal(got, fp252_cuda.batch_inv_plain(x))
        x.view(n, -1, 8)[n // 2, -1] = 0
        (got,) = fp252_cuda.batch_inv_segments([x])
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
    got = fp252_cuda.batch_inv_segments(xs)
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
    first = [fp252_cuda.scan_mul(x), fp252_cuda.scan_mul(x3, True),
             fp252_cuda.batch_inv_segments([x, x3])]
    assert torch.equal(first[0], prefix_scan(fp252_cuda.mul_plain, x))
    assert torch.equal(first[1],
                       prefix_scan(fp252_cuda.mul_plain, x3, True))
    assert torch.equal(first[2][1], fp252_cuda.batch_inv_plain(x3))
    for _ in range(20):
        assert torch.equal(fp252_cuda.scan_mul(x), first[0])
        assert torch.equal(fp252_cuda.scan_mul(x3, True), first[1])
        got = fp252_cuda.batch_inv_segments([x, x3])
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
