"""The redesigned fp252_affine_scan and FRI fold on the CPU: a plain model
of each kernel's design against the JAX package, word for word.

- the affine pair scan (csrc/scan.cu affine_kernel): tiles of `threads`
  runs of `run` rows, each thread's run composed, the warp's inclusive
  scan and the warps' totals, every tile publishing its aggregate only, a
  tile's prefix the ordered product of all earlier aggregates (farthest
  first, one block product a step of `threads` tiles: several steps where
  the tiles outnumber the threads), applied to 1 and carried through the
  earlier warps' and lanes' maps, then y = y a + b a row; at n = 1, 37,
  255, 256, 257 and 5000, with the kernel's 256 threads and the run
  fields/fp252_cuda.py affine_plan gives, and with small blocks whose
  tiles equal and exceed their threads, against
  sandstorm_tpu/fields/scan.py prefix_scan with the layouts' compose and
  the leading one (the JAX package's diluted aggregate), and with blocks
  of one small warp against the port's plain affine_scan_plain;
  affine_plan's runs and tile counts;
- the FRI fold (csrc/fri.cu fold_kernel): every form the entry picks, a
  thread an output to f / 2 lanes an output (outputs a warp, pairs by a
  shuffle, the squares in the lane that holds them), each later
  multiplier the square of the one before (the GF(p^3) thread form: the
  table at every halving), over Fp252, GL and GF(p^3) at f = 2, 4, 8,
  16, on a layer led by p - 1, 0 and 1 and on a layer of p - 1, against
  sandstorm_tpu/stark/fri.py fri_fold_device (its _fold_halvings);
  fields/field_cuda.py fold_lanes (the entry's choice) at the cells'
  layers and its constant against the source's.

The kernels themselves run on the card: tests/test_torch_cuda.py and
chip_smoke.py hold them to the plain versions there.  Tolerance 0: the
arithmetic is exact.
"""

import functools
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.fields.fp252 import Fp252 as JF
from sandstorm_tpu.fields.gl3 import GL3 as JG3
from sandstorm_tpu.fields.goldilocks import GL as JGL
from sandstorm_tpu_torch.fields import field_cuda, fp252_cuda, gl_cuda
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.fields.gl3 import GL3
from sandstorm_tpu_torch.fields.goldilocks import GL
from sandstorm_tpu_torch.fields.scan import affine_scan_plain, compose_maps
from sandstorm_tpu_torch.interop import from_jax_digits, to_jax_digits
from sandstorm_tpu_torch.ntt import powers_dev
from sandstorm_tpu_torch.ntt.ntt_cuda import transform_field
from sandstorm_tpu_torch.stark.fri import fold_scalars

CPU = torch.device("cpu")
FIELDS = {"fp252": (TF, JF), "goldilocks": (GL, JGL), "gl3": (GL3, JG3)}
H100_SMS = 132


def _vals(F, rng, count):
    """count field values (packed ints), the first three p - 1 (every
    coordinate p - 1 over GF(p^3)), 0 and 1."""
    edge = [F.MODULUS - 1, 0, 1]
    return (edge + [rng.randrange(F.MODULUS) for _ in range(count)])[:count]


def _to_jax(F, t):
    if F.NLIMBS == 8:
        return jnp.asarray(to_jax_digits(t))
    return jnp.asarray(t.contiguous().numpy().view(np.uint32))


def _from_jax(F, arr):
    if F.NLIMBS == 8:
        return from_jax_digits(np.asarray(arr))
    return torch.from_numpy(np.asarray(arr).view(np.int32).copy())


# -- the affine pair scan -------------------------------------------------------

AFFINE_N = [1, 37, 255, 256, 257, 5000]


@functools.lru_cache(maxsize=None)
def _affine_case():
    """5000 maps (python ints) and the JAX package's aggregate column over
    them: [1] + a + b of the maps 0..k composed, by prefix_scan with the
    layouts' compose.  The column of the first n maps is its first n + 1
    rows, so one JAX scan serves every n."""
    from sandstorm_tpu.fields.scan import prefix_scan as jax_scan
    n = AFFINE_N[-1]
    rng = random.Random(20)
    a, b = _vals(TF, rng, n), _vals(TF, rng, n)[::-1]
    ja, jb = jax_scan(compose_maps(JF), (_to_jax(TF, TF.encode_ints(a, CPU)),
                                         _to_jax(TF, TF.encode_ints(b, CPU))))
    col = jnp.concatenate([JF.ones((1,)), JF.add(ja, jb)], axis=0)
    return a, b, TF.decode_ints(_from_jax(TF, col))


def _affine_model(a, b, threads, run, warp=32):
    """csrc/scan.cu's affine_kernel on python ints, a block of `threads`
    threads in warps of `warp` lanes: the column [1, y_0, ..., y_{n-1}]."""
    P = TF.MODULUS
    ident = (1, 0)

    def op(x, y):               # x then y
        return x[0] * y[0] % P, (x[1] * y[0] + y[1]) % P

    def apply(m, x):
        return (x * m[0] + m[1]) % P

    def hillis_steele(vals):     # inclusive, lane l - d before lane l
        v = list(vals)
        d = 1
        while d < len(v):
            v = [op(v[l - d], v[l]) if l >= d else v[l]
                 for l in range(len(v))]
            d <<= 1
        return v

    def butterfly(vals):         # lane 0's product, lower half first
        v = list(vals)
        v += [ident] * ((1 << (len(v) - 1).bit_length()) - len(v))
        m = 1
        while m < len(v):
            v = [op(v[l], v[l ^ m]) if not l & m else op(v[l ^ m], v[l])
                 for l in range(len(v))]
            m <<= 1
        return v[0]

    def block_product(vals, live):
        parts = []
        for w0 in range(0, threads, warp):
            lanes = vals[w0:w0 + warp]
            parts.append(butterfly(lanes) if w0 < live else lanes[0])
        return butterfly(parts)

    n = len(a)
    tile = threads * run
    tiles = max(1, -(-n // tile))
    agg, scans = [], []
    for tid in range(tiles):          # every tile publishes before it waits
        g = []
        for t in range(threads):
            acc = ident
            for r in range(run):
                i = tid * tile + t * run + r
                if i < n:
                    acc = (a[i], b[i]) if r == 0 else op(acc, (a[i], b[i]))
            g.append(acc)
        lanes = []
        for w0 in range(0, threads, warp):
            lanes += hillis_steele(g[w0:w0 + warp])
        totals = hillis_steele([lanes[w0 + warp - 1]
                                for w0 in range(0, threads, warp)])
        agg.append(totals[-1])
        scans.append((lanes, totals))
    out = [1] + [None] * n
    for tid in range(tiles):
        p = 1
        if tid:
            acc = ident
            for c0 in range(0, tid, threads):
                vals = [agg[c0 + t] if c0 + t < tid else ident
                        for t in range(threads)]
                acc = op(acc, block_product(vals, min(threads, tid - c0)))
            p = (acc[0] + acc[1]) % P
        lanes, totals = scans[tid]
        for t in range(threads):
            w, lane = divmod(t, warp)
            y = apply(totals[w - 1], p) if w else p
            if lane:
                y = apply(lanes[t - 1], y)
            for r in range(run):
                i = tid * tile + t * run + r
                if i < n:
                    y = (y * a[i] + b[i]) % P
                    out[i + 1] = y
    return out


@pytest.mark.parametrize("threads,warp,run", [
    (256, 32, None),   # the kernel's block, affine_plan's run: one step
    (16, 4, 1),        # 16 tiles at n = 256 (= threads), more above
    (8, 4, 2)])        # tiles past the threads: the look-back's steps
@pytest.mark.parametrize("n", AFFINE_N)
def test_affine_scan_design_matches_jax(n, threads, warp, run):
    """The redesigned affine scan's tiles, block scan, aggregates-only
    prefix (one block product, or several steps) and walk give the JAX
    package's aggregate column of the first n maps."""
    a, b, want = _affine_case()
    if run is None:
        run, tiles = fp252_cuda.affine_plan(n, H100_SMS)
        assert tiles <= threads
    assert _affine_model(a[:n], b[:n], threads, run, warp) == want[:n + 1]


@pytest.mark.parametrize("n,threads,run", [(37, 4, 2), (64, 2, 1),
                                           (100, 3, 4), (1, 4, 1)])
def test_affine_scan_kernel_model(n, threads, run):
    """The kernel's tiles, block scan and aggregates-only prefix, with
    blocks of one warp of `threads` lanes (a tile whose predecessors
    outnumber the threads takes them over several steps), give the
    port's plain version's column."""
    rng = random.Random(n + threads)
    a, b = _vals(TF, rng, n), _vals(TF, rng, n)[::-1]
    want = TF.decode_ints(affine_scan_plain(TF, TF.encode_ints(a, CPU),
                                            TF.encode_ints(b, CPU)))
    assert _affine_model(a, b, threads, run, warp=threads) == want


def test_affine_plan_one_wave():
    """affine_plan: the shortest run whose tiles are at most one an SM and
    one block product's worth; 2^18 - 1 maps (starknet's and recursive's)
    in 128 tiles of runs of 8 on 132 SMs; past 132 tiles of runs of 8 the
    longest run, whose tiles (more than the card holds at once) look back
    over several steps past 256 of them."""
    T = fp252_cuda.SCAN_THREADS
    plan = fp252_cuda.affine_plan
    assert plan((1 << 18) - 1, H100_SMS) == (8, 128)
    assert plan(1, H100_SMS) == (1, 1)
    assert plan(0, H100_SMS) == (1, 1)
    for n in (1, 255, 256, 257, 5000, 1 << 15, 1 << 16, 1 << 17,
              (1 << 18) + 1, H100_SMS * T * 8):
        run, tiles = plan(n, H100_SMS)
        assert tiles == max(1, -(-n // (T * run))) <= H100_SMS
        for r in fp252_cuda.AFFINE_RUNS:
            if r < run:
                assert -(-n // (T * r)) > H100_SMS
    assert plan(H100_SMS * T * 8 + 1, H100_SMS) == (8, H100_SMS + 1)
    run, tiles = plan(1 << 21, H100_SMS)
    assert run == fp252_cuda.AFFINE_RUNS[-1] and tiles == 1024 > T
    assert fp252_cuda.affine_status_words(256) == 8 + 256 + 16 * 256


# -- the FRI fold -------------------------------------------------------------

FOLD_N = 64


@functools.lru_cache(maxsize=None)
def _fold_case(name, f, values):
    """A layer of FOLD_N values (led by p - 1, 0 and 1, or every one p -
    1), its coset and beta, and the JAX package's fold of it
    (fri_fold_device, its _fold_halvings; over GF(p^3) run eagerly, each
    field op its own jit: the jitted body compiles for minutes on
    XLA:CPU)."""
    from sandstorm_tpu.stark import fri as jax_fri
    F, JFd = FIELDS[name]
    rng = random.Random(FOLD_N * 7 + f)
    ints = _vals(F, rng, FOLD_N)
    if values == "p_minus_1":
        ints = [F.MODULUS - 1] * FOLD_N
    x = F.encode_ints(ints, CPU)
    coset = pow(F.GENERATOR, 7, F.BASE_MODULUS)
    beta = rng.randrange(2, F.MODULUS)
    halvings = jax_fri._fold_halvings
    if name == "gl3":
        jax_fri._fold_halvings = halvings.__wrapped__
    try:
        want = jax_fri.fri_fold_device(JFd, _to_jax(F, x), coset, FOLD_N, f,
                                       beta)
    finally:
        jax_fri._fold_halvings = halvings
    return F, x, coset, beta, _from_jax(F, want)


def _fold_inputs(F, x, coset, N, f, beta):
    """The fold's table (the transform field's w^-i), and its pair step:
    step(u, w, m, s) -> (value, m) as fri.cu's step computes it."""
    T = transform_field(F)
    w_inv = pow(F.root_of_unity_int(N), -1, F.BASE_MODULUS)
    xinv = powers_dev(T, w_inv, N // 2, CPU)[:, :T.NLIMBS]
    scals = torch.from_numpy(F.encode_ints_np(fold_scalars(F, coset, f,
                                                           beta)).copy())
    if F.NLIMBS == 8:
        add, sub, mul = (fp252_cuda.add_plain, fp252_cuda.sub_plain,
                         fp252_cuda.mul_plain)
        square = lambda m: fp252_cuda.mul_plain(m, m)   # noqa: E731
    else:
        add, sub, mul = gl_cuda.plain_ops(F.NLIMBS)
        square = lambda m: gl_cuda.mul_plain(m, m)      # noqa: E731

    def step(u, w, m, s, squares):
        if squares and F.NLIMBS != 6:    # m = x^-1 beta_0, then its squares
            m = mul(m, scals[0]) if s == 0 else square(m)
            return add(add(u, w), mul(sub(u, w), m)), m
        if squares and s:                # a base-field m, squared
            m = square(m)
        d = sub(u, w)                    # (u + w) + (u - w) m scal_s
        if F.NLIMBS == 6:
            d = gl_cuda.mul_plain(d.reshape(-1, 3, 2),
                                  m[:, None, :]).reshape(-1, 6)
        else:
            d = mul(d, m)
        return add(add(u, w), mul(d, scals[s])), m

    return xinv, step


def _fold_kernel_model(F, x, coset, N, f, beta, lg):
    """csrc/fri.cu's fold_kernel over every thread of its grid: LO = 2^lg
    lanes an output, O = 32 / LO outputs a warp, lane l holding output
    warp O + l % O's inputs k = j + LO c (j = l / O, c < f / LO); halving
    s pairs c and c + h / LO in the lane while h >= LO, then lane j takes
    lane j + h's value (a shuffle down by h O; a lane past the warp keeps
    its own); the pair's multiplier as fri.cu's step forms it (over Fp252
    and GL x^-1 beta_0, then its squares; over GF(p^3) the base x^-1
    squared; the GF(p^3) thread form reads the table at every halving,
    xinv[(i + k M) 2^s]); lane j = 0 stores."""
    xinv, step = _fold_inputs(F, x, coset, N, f, beta)
    table = F.NLIMBS == 6 and lg == 0
    M, LO = N // f, 1 << lg
    O, K = 32 // LO, f // LO
    t = torch.arange(-(-M // O) * 32)
    lane = t % 32
    j, i = lane // O, (t // 32) * O + lane % O
    live = i < M
    ic = torch.where(live, i, 0)
    c = [x[ic + (j + LO * q) * M] for q in range(K)]
    m = [xinv[ic + (j + LO * q) * M] for q in range(K // 2)]

    def read(q, s):            # the table at halving s for the lane's pair q
        at = (ic + (j + LO * q) * M) << s      # past the table: idle lanes
        return xinv[torch.where(at < N // 2, at, 0)]

    for s in range(f.bit_length() - 1):
        h = f >> (s + 1)
        if h >= LO:
            for q in range(h // LO):
                if table and s:
                    m[q] = read(q, s)
                c[q], m[q] = step(c[q], c[q + h // LO], m[q], s, not table)
        else:
            src = torch.where(lane + h * O < 32, t + h * O, t)
            act = (live & (j < h))[:, None]
            v, m0 = step(c[0], c[0][src], read(0, s) if table else m[0], s,
                         not table)
            c[0] = torch.where(act, v, c[0])
            m[0] = torch.where(act, m0, m[0])
    return c[0][live & (j == 0)]


@pytest.mark.parametrize("values", ["edges", "p_minus_1"])
@pytest.mark.parametrize("f,lg", [(f, lg) for f in (2, 4, 8, 16)
                                  for lg in range(f.bit_length() - 1)])
@pytest.mark.parametrize("name", ["fp252", "goldilocks", "gl3"])
def test_fold_design_matches_jax(name, f, lg, values):
    """The fold kernel's every form, 2^lg lanes an output (a thread an
    output to f / 2 lanes), gives the JAX package's fold word for word."""
    F, x, coset, beta, want = _fold_case(name, f, values)
    got = _fold_kernel_model(F, x, coset, FOLD_N, f, beta, lg)
    assert got.shape == (FOLD_N // f, F.NLIMBS)
    assert torch.equal(got, want)


def test_fold_mode_at_the_cells_layers():
    """fold_lanes on 132 SMs, f = 8: a thread an output at every cell's
    layer 0 (starknet 2^19 outputs, recursive 2^16, the GL cells 2^18)
    and at starknet's layer 1 and the GL cells' (2^16, 2^15); 2 lanes at
    2^13 outputs (starknet's layer 2, recursive's 1), 4 at 2^12 and fewer;
    at f = 16 up to 8 lanes; at f = 2 one; its constants and rule are
    csrc/fri.cu's."""
    lanes = field_cuda.fold_lanes
    for M in (1 << 19, 1 << 18, 1 << 16, 1 << 15, 16897):
        assert lanes(M, 8, H100_SMS) == 0
    assert lanes(1 << 13, 8, H100_SMS) == 1
    for M in (1 << 12, 1 << 10, 1 << 9, 1 << 7, 1 << 6, 1 << 4, 8, 1):
        assert lanes(M, 8, H100_SMS) == 2
    assert lanes(16896, 8, H100_SMS) == 0
    assert lanes(8448, 8, H100_SMS) == 1 and lanes(4224, 8, H100_SMS) == 2
    assert lanes(1 << 10, 16, H100_SMS) == 3
    assert lanes(1 << 4, 2, H100_SMS) == 0
    src = (Path(field_cuda.__file__).parents[1] / "csrc" / "fri.cu").read_text()
    assert (f"constexpr long long LANE_THREADS = "
            f"{field_cuda.FOLD_LANE_THREADS};") in src
    assert (f"constexpr int MAX_STAGES = {field_cuda.FOLD_MAX_STAGES};"
            in src)
    assert "while (lg + 1 < S && (M << (lg + 1)) <= cap) lg++;" in src
