"""The port's Goldilocks and GF(p^3) fields, kernels' plain twins and
transforms (sandstorm_tpu_torch/fields/{goldilocks,gl3,gl_cuda}.py,
ntt/) against the JAX package's GL, GL3, Fq3S, the Pallas Goldilocks leaf
body and sandstorm_tpu.ntt, on the CPU.

Inputs are made from a seed; both packages store an element as the same
u32 words (GL [..., 2], GL3 [..., 6]), handed over as numpy.  Tolerance 0
everywhere: the arithmetic is exact.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.fields.gl3 import GL3 as JG3
from sandstorm_tpu.fields.gl3 import Fq3S as JFq3S
from sandstorm_tpu.fields.goldilocks import GL as JGL
from sandstorm_tpu.fields.scan import prefix_mul as jax_prefix_mul
from sandstorm_tpu.ntt import coset_eval_from_coeffs as jax_coset_eval
from sandstorm_tpu.ntt import ntt as jax_ntt
from sandstorm_tpu_torch import _native
from sandstorm_tpu_torch.fields import fp252_cuda, gl_cuda
from sandstorm_tpu_torch.fields.gl3 import GL3, Fq3S, Q
from sandstorm_tpu_torch.fields.goldilocks import GL
from sandstorm_tpu_torch.fields.scan import prefix_mul
from sandstorm_tpu_torch.ntt import coset_eval_from_coeffs, intt, ntt
from sandstorm_tpu_torch.ntt import ntt_cuda

P = JGL.MODULUS
CPU = torch.device("cpu")
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 64) - (1 << 32),
         (1 << 63), (1 << 63) + (1 << 32)]


def _gl_ints(seed, n):
    rng = random.Random(seed)
    return (EDGES + [rng.randrange(P) for _ in range(n)])[:n]


def _gl3_ints(seed, n):
    """Packed GF(p^3) values: base-field edges embedded, coordinates from
    the edge set, then random."""
    rng = random.Random(seed)
    coords = [JFq3S(a, b, c) for a, b, c in
              zip(EDGES, EDGES[3:] + EDGES[:3], EDGES[::-1])]
    return ([0, 1, P - 1] + [int(x) for x in coords]
            + [rng.randrange(Q) for _ in range(n)])[:n]


def _both(F, JF, vals):
    """The same elements as a JAX uint32 array and a port int32 tensor."""
    words = JF.encode_ints_np(vals)
    return jnp.asarray(words), torch.from_numpy(
        np.ascontiguousarray(words).view(np.int32).copy())


def _agree(jax_arr, port_t):
    return np.array_equal(np.asarray(jax_arr), port_t.numpy().view(np.uint32))


# -- GL -----------------------------------------------------------------------

def test_gl_encoding_matches_jax_and_round_trips():
    vals = _gl_ints(0, 40)
    t = GL.encode_ints(vals, CPU)
    assert np.array_equal(t.numpy().view(np.uint32), JGL.encode_ints_np(vals))
    assert GL.decode_ints(t) == vals
    u64 = np.zeros((len(vals), 4), dtype=np.uint64)
    u64[:, 0] = np.array(vals, dtype=np.uint64)
    got = GL.encode_canonical_u64_many([u64, u64[::-1]], CPU)
    assert _agree(JGL.encode_canonical_u64(u64), got[0])
    assert GL.decode_ints(got[1]) == vals[::-1]
    u64[3, 1] = 1       # a value above 2^64: the store must not truncate it
    with pytest.raises(AssertionError):
        GL.encode_canonical_u64(u64, CPU)
    with pytest.raises(AssertionError):
        GL3.encode_canonical_u64(u64, CPU)


def _gl_u64(rng, k, n):
    """k numpy [n, 4] uint64 columns of Goldilocks values (word 0; p - 1,
    0 and the edges in the first rows, then random)."""
    cols = np.zeros((k, n, 4), dtype=np.uint64)
    cols[..., 0] = rng.integers(0, P, size=(k, n), dtype=np.uint64)
    cols[:, :min(n, len(EDGES)), 0] = EDGES[:n]
    return [c.copy() for c in cols]


def _stacked_upload_gl(F, cols):
    """The columns stacked and their low words copied out and uploaded
    whole, GF(p^3)'s zero coordinates appended: the upload that
    staging.upload replaced."""
    stacked = np.stack([np.asarray(c, dtype=np.uint64) for c in cols])
    low = np.ascontiguousarray(stacked[..., 0]).view("<u4")
    t = torch.from_numpy(low.reshape(stacked.shape[:-1] + (2,))
                         .view(np.int32).copy())
    if F is GL3:
        t = torch.cat([t, t.new_zeros(t.shape[:-1] + (4,))], dim=-1)
    return t


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["contiguous", "reversed"])
@pytest.mark.parametrize("n", [1 << 4, 1 << 12])
@pytest.mark.parametrize("k", [1, 7, 9])
@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_encode_canonical_u64_many_matches_the_stacked_upload(name, k, n,
                                                              reverse):
    """GL / GL3 encode_canonical_u64_many bit-identical to the stacked
    upload and to the JAX package's encode, views of one [k, n, L] tensor;
    a second call after the sources were rewritten in place returns the new
    values and leaves the first call's as they were; a value above the
    field still raises."""
    F, JF = {"goldilocks": (GL, JGL), "gl3": (GL3, JG3)}[name]
    rng = np.random.default_rng(k * n + reverse)
    cols = _gl_u64(rng, k, n)
    src = [c[::-1] for c in cols] if reverse else cols
    want, got = [], []
    for new in (None, _gl_u64(rng, k, n)):
        if new is not None:
            for c, v in zip(cols, new):
                c[...] = v
        want.append(_stacked_upload_gl(F, src))
        got.append(F.encode_canonical_u64_many(src, CPU, "base_columns"))
        assert _agree(JF.encode_canonical_u64(np.stack(src)), got[-1][0]._base)
    for g, w in zip(got, want):
        assert len(g) == k
        assert all(t._base is g[0]._base for t in g)
        assert torch.equal(g[0]._base, w)
    assert not torch.equal(want[0], want[1])
    cols[-1][n // 2, 0] = P
    with pytest.raises(AssertionError):
        F.encode_canonical_u64_many(src, CPU, "base_columns")


def _wide_borrow_pairs(rng, count):
    """Pairs whose 128-bit product has its top word w3 above its low 64
    bits (w1, w0), so the reduction takes its borrow path: multiples of
    2^32 whose product's low half is 0, and a few near 2^63."""
    pairs = [((1 << 63), (1 << 63)), ((1 << 63), (1 << 63) + (1 << 33))]
    while len(pairs) < count:
        x, y = rng.randrange(1 << 16, 1 << 32), rng.randrange(1 << 16, 1 << 32)
        if x * y >= 1 << 32:
            pairs.append((x << 32, y << 32))
    for a, b in pairs:
        assert a < P and b < P
        assert (a * b) >> 96 > (a * b) & ((1 << 64) - 1)
    return pairs


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_gl_binop_matches_jax(op):
    rng = random.Random(11)
    xs = _gl_ints(1, 60)
    ys = _gl_ints(2, 60)[::-1]
    # every edge against every edge, and products that take the borrow
    xs += [a for a in EDGES for _ in EDGES]
    ys += [b for _ in EDGES for b in EDGES]
    for a, b in _wide_borrow_pairs(rng, 12):
        xs.append(a)
        ys.append(b)
    ja, ta = _both(GL, JGL, xs)
    jb, tb = _both(GL, JGL, ys)
    got = getattr(GL, op)(ta, tb)
    assert _agree(getattr(JGL, op)(ja, jb), got)
    want = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
            "mul": lambda x, y: x * y % P}[op]
    assert GL.decode_ints(got) == [want(x, y) for x, y in zip(xs, ys)]


def test_gl_neg_sqr_pow_inv_batch_inv_match_jax():
    xs = _gl_ints(3, 40)
    ja, ta = _both(GL, JGL, xs)
    assert _agree(JGL.neg(ja), GL.neg(ta))
    assert GL.decode_ints(GL.sqr(ta)) == [x * x % P for x in xs]
    for e in (0, 1, 2, 7, 65537, P - 2):
        assert GL.decode_ints(GL.pow_static(ta, e)) == \
            [pow(x, e, P) for x in xs]
    assert _agree(JGL.inv(ja), GL.inv(ta))              # inv(0) = 0 on both
    nz = [x for x in xs if x]
    jn, tn = _both(GL, JGL, nz)
    got = GL.batch_inv(tn)
    assert _agree(JGL.batch_inv(jn), got)
    assert GL.decode_ints(got) == [pow(x, -1, P) for x in nz]


# -- GF(p^3) ------------------------------------------------------------------

def test_fq3s_is_the_jax_scalar():
    rng = random.Random(4)
    for _ in range(20):
        a, b = rng.randrange(Q), rng.randrange(Q)
        for op in ("__add__", "__sub__", "__mul__"):
            assert int(getattr(Fq3S.from_packed(a), op)(
                Fq3S.from_packed(b))) == int(getattr(
                    JFq3S.from_packed(a), op)(JFq3S.from_packed(b)))
        assert int(Fq3S.from_packed(a).frob()) == \
            int(JFq3S.from_packed(a).frob())
        if a:
            assert int(Fq3S.from_packed(a).inv()) == \
                int(JFq3S.from_packed(a).inv())
    assert GL3.s(-1) == JG3.s(-1)


def test_gl3_encoding_and_hash_bytes_match_jax():
    vals = _gl3_ints(5, 30)
    t = GL3.encode_ints(vals, CPU)
    assert np.array_equal(t.numpy().view(np.uint32), JG3.encode_ints_np(vals))
    assert GL3.decode_ints(t) == vals
    assert GL3.decode_ints(GL3.encode_int(Fq3S(1, 2, 3), CPU)) == \
        [int(Fq3S(1, 2, 3))]
    for v in vals:
        assert GL3.to_hash_bytes_int(v) == JG3.to_hash_bytes_int(v)
    u64 = np.zeros((6, 4), dtype=np.uint64)
    u64[:, 0] = np.array(EDGES[:6], dtype=np.uint64)
    assert _agree(JG3.encode_canonical_u64(u64),
                  GL3.encode_canonical_u64(u64, CPU))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_gl3_ops_match_jax_and_fq3s(op):
    xs, ys = _gl3_ints(6, 48), _gl3_ints(7, 48)[::-1]
    ja, ta = _both(GL3, JG3, xs)
    jb, tb = _both(GL3, JG3, ys)
    got = getattr(GL3, op)(ta, tb)
    assert _agree(getattr(JG3, op)(ja, jb), got)
    assert GL3.decode_ints(got) == [
        int(getattr(Fq3S.from_packed(x), f"__{op}__")(Fq3S.from_packed(y)))
        for x, y in zip(xs, ys)]
    # broadcast: a [6] scalar against the column
    assert _agree(getattr(JG3, op)(ja, jb[5]), getattr(GL3, op)(ta, tb[5]))


def test_gl3_mul_plain_equals_the_composed_form():
    """gl3_mul (one kernel launch on a card) and its plain twin equal the
    JAX GL3.mul composed of 9 GL muls and the x^3 = 2 reduction."""
    xs, ys = _gl3_ints(8, 64), _gl3_ints(9, 64)
    ja, ta = _both(GL3, JG3, xs)
    jb, tb = _both(GL3, JG3, ys)
    got = gl_cuda.gl3_mul_plain(ta.reshape(8, 8, 6), tb.reshape(8, 8, 6))
    assert _agree(JG3.mul(ja, jb), got.reshape(64, 6))
    assert torch.equal(gl_cuda.gl3_mul(ta, tb), got.reshape(64, 6))


def test_gl3_frob_neg_pow_inv_batch_inv_match_jax():
    xs = _gl3_ints(10, 24)
    ja, ta = _both(GL3, JG3, xs)
    assert _agree(JG3.frob(ja), GL3.frob(ta))
    assert _agree(JG3.neg(ja), GL3.neg(ta))
    assert GL3.decode_ints(GL3.pow_static(ta, 5)) == \
        [int(Fq3S.from_packed(x) ** 5) for x in xs]
    assert _agree(JG3.inv(ja), GL3.inv(ta))              # inv(0) = 0 on both
    nz = [x for x in xs if x]
    jn, tn = _both(GL3, JG3, nz)
    got = GL3.batch_inv(tn)
    assert _agree(JG3.batch_inv(jn), got)
    assert GL3.decode_ints(got) == [int(Fq3S.from_packed(x).inv())
                                    for x in nz]


@pytest.mark.parametrize("field", ["gl", "gl3"])
@pytest.mark.parametrize("reverse", [False, True])
def test_prefix_mul_any_width(field, reverse):
    """fields/scan.py's running product on [n, 2] and [n, 6]."""
    F, JF, ints = ((GL, JGL, _gl_ints) if field == "gl"
                   else (GL3, JG3, _gl3_ints))
    xs = ints(12, 21)
    ja, ta = _both(F, JF, xs)
    assert _agree(jax_prefix_mul(JF, ja, reverse=reverse),
                  prefix_mul(F, ta, reverse=reverse))


@pytest.mark.parametrize("width", [2, 6])
@pytest.mark.parametrize("a_shape,b_shape", [
    ((4, 6, 5), ()), ((4, 6, 5), (4, 6, 1)), ((4, 6, 5), (6, 1)),
    ((4, 6, 5), (5,)), ((4, 6, 5), (4, 1, 5))])
def test_kernel_operand_index_rule_any_width(width, a_shape, b_shape):
    """The Goldilocks kernels read operand element (i // div) % mod, as the
    Fp252 ones do; the wrapper's (div, mod) reproduce torch broadcasting at
    2 and 6 words per element."""
    shape = torch.broadcast_shapes(a_shape, b_shape)
    n = int(np.prod(shape))
    x = torch.arange(int(np.prod(b_shape)) * width,
                     dtype=torch.int32).reshape(tuple(b_shape) + (width,))
    t, div, mod = fp252_cuda._operand(x, shape)
    want = x.expand(tuple(shape) + (width,)).reshape(n, width)
    idx = (torch.arange(n) // div) % mod
    assert torch.equal(t.reshape(-1, width)[idx], want)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never builds or launches a kernel; a non-CPU tensor goes
    to the kernel wrapper, which raises rather than falling back."""
    _, ta = _both(GL3, JG3, _gl3_ints(13, 8))
    before = dict(_native.LAUNCHES)
    GL3.mul(ta, ta)
    GL3.add(ta, ta)
    GL.mul(ta[:, :2], ta[:, 2:4])
    ntt_cuda.gl_ntt_leaf_fused(
        ta[:, :4].reshape(8, 2, 2), ntt_cuda.stage_table(GL, 8, False, CPU),
        ntt_cuda._rc_twiddle(GL, 16, 8, False, CPU), 1)
    assert dict(_native.LAUNCHES) == before and _native._lib is None
    for fn, w in ((lambda m: gl_cuda.binop("mul", m, m), 2),
                  (lambda m: gl_cuda.gl3_mul(m, m), 6),
                  (lambda m: ntt_cuda.gl_ntt_leaf(
                      m, torch.empty((4, 2), dtype=torch.int32,
                                     device="meta")), 2),
                  (lambda m: ntt_cuda.gl_ntt_leaf_fused(
                      m, torch.empty((4, 2), dtype=torch.int32,
                                     device="meta"),
                      torch.empty((8, 1, 1, 2), dtype=torch.int32,
                                  device="meta"), 1), 2)):
        meta = torch.empty((8, 1, w), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(meta)
    assert _native._lib is None


# -- the leaf and the transforms ----------------------------------------------

class _MockRef:
    """Eager stand-in for a Pallas VMEM ref (as in tests/test_ntt.py)."""

    def __init__(self, arr):
        self.arr = arr
        self.shape = arr.shape

    def __getitem__(self, k):
        return self.arr[k]

    def __setitem__(self, k, v):
        self.arr = self.arr.at[k].set(v)


@pytest.mark.parametrize("M", [16, 64])
def test_plain_gl_leaf_matches_pallas_leaf_body(M):
    """The port's plain Goldilocks leaf (natural order in, bit-reversal
    inside) equals the TPU leaf kernel body _mk_ntt_kernel("goldilocks")
    on bit-reversed (lo, hi)-major input."""
    from sandstorm_tpu.ntt import ntt_pallas as mod
    from sandstorm_tpu.ntt.ntt import bit_reverse_perm
    B = mod.TB
    _, ta = _both(GL, JGL, _gl_ints(M, M * B))
    x = ta.reshape(M, B, 2)
    for inverse in (False, True):
        tw = ntt_cuda.stage_table(GL, M, inverse, CPU)
        got = ntt_cuda.gl_ntt_leaf(x, tw)
        x_dm = jnp.asarray(x.numpy().view(np.uint32)[bit_reverse_perm(M)]
                           .transpose(2, 0, 1))                  # [2, M, B]
        out = _MockRef(jnp.zeros_like(x_dm))
        mod._mk_ntt_kernel("goldilocks")(
            _MockRef(x_dm), jnp.asarray(mod._stage_tables_np(JGL, M, inverse)),
            out)
        assert _agree(jnp.transpose(out.arr, (1, 2, 0)), got)


@pytest.mark.parametrize("field", ["gl", "gl3"])
@pytest.mark.parametrize("n", [16, 512])
def test_ntt_intt_coset_eval_match_jax(field, n):
    F, JF, ints = ((GL, JGL, _gl_ints) if field == "gl"
                   else (GL3, JG3, _gl3_ints))
    ja, ta = _both(F, JF, ints(n, n))
    assert _agree(jax_ntt(JF, ja), ntt(F, ta))
    assert _agree(jax_ntt(JF, ja, inverse=True), intt(F, ta))
    assert _agree(jax_coset_eval(JF, ja, 2 * n, JF.GENERATOR),
                  coset_eval_from_coeffs(F, ta, 2 * n, F.GENERATOR))


def test_gl_fourstep_split_matches_single_leaf():
    """n = 512 at a 256-point leaf cap takes one four-step level (two leaf
    passes, a twiddle multiply and a transpose); it must equal one 512-point
    leaf, for a batch of 3 GL columns and of 2 GL3 columns (6 GL columns),
    both directions, and the JAX transform."""
    n = 512
    _, ta = _both(GL, JGL, _gl_ints(21, 3 * n))
    x = ta.reshape(n, 3, 2)
    for inverse in (False, True):
        split = ntt_cuda.batched_ntt(GL, x, inverse, m_max=256)
        assert torch.equal(split, ntt_cuda.batched_ntt(GL, x, inverse,
                                                       m_max=512))
    _, t3 = _both(GL3, JG3, _gl3_ints(22, 2 * n))
    cols = ntt(GL3, t3.reshape(n, 2, 6)).unbind(1)
    for c in range(2):
        jcol = jnp.asarray(t3.reshape(n, 2, 6)[:, c].numpy().view(np.uint32))
        assert _agree(jax_ntt(JG3, jcol), cols[c])


@pytest.mark.parametrize("R,C,Bi", [(16, 8, 1), (16, 7, 3), (64, 5, 5),
                                    (32, 3, 15), (8, 13, 2)])
def test_gl_fused_leaf_plain_is_leaf_mul_transpose(R, C, Bi):
    """The fused Goldilocks first leaf's plain twin (the CPU side of
    gl_ntt_leaf_fused) equals gl_ntt_leaf, then gl_mul by w^(k c), then the
    transpose to [C, R * Bi], for widths Bi that no tile of adjacent
    transforms divides and odd C; a few outputs equal the python-int sum.
    rc here is any [R, C] table (the kernel's contract: C need not be a
    power of two), then powers w^(r c) of a root of unity."""
    vals = _gl_ints(R + C + Bi, R * C * Bi)
    _, ta = _both(GL, JGL, vals)
    x = ta.reshape(R, C * Bi, 2)
    tw = ntt_cuda.stage_table(GL, R, False, CPU)
    _, rnd = _both(GL, JGL, _gl_ints(7 * R + C, R * C))
    for rc in (rnd.reshape(R, C, 1, 2),
               GL.encode_ints([pow(GL.root_of_unity_int(1 << 20), r * c, P)
                               for r in range(R) for c in range(C)],
                              CPU).reshape(R, C, 1, 2)):
        got = ntt_cuda.gl_ntt_leaf_fused(x, tw, rc, Bi)
        assert got.shape == (C, R * Bi, 2)
        leaf = ntt_cuda.gl_ntt_leaf(x, tw).reshape(R, C, Bi, 2)
        want = GL.mul(leaf, rc).transpose(0, 1).contiguous().reshape(
            C, R * Bi, 2)
        assert torch.equal(got, want)
    wR = GL.root_of_unity_int(R)
    out = GL.decode_ints(got.reshape(-1, 2))
    for c, k, b in [(0, 0, 0), (1, 1, 0), (C - 1, R - 1, Bi - 1),
                    (2, 5, Bi // 2)]:
        s = sum(vals[(r * C + c) * Bi + b] * pow(wR, r * k, P)
                for r in range(R)) * pow(GL.root_of_unity_int(1 << 20),
                                         k * c, P) % P
        assert out[(c * R + k) * Bi + b] == s


@pytest.mark.parametrize("field", ["gl", "gl3"])
@pytest.mark.parametrize("n,cap", [(512, 32), (8192, 32), (8192, None)])
def test_fourstep_with_fused_first_leaf_matches_jax(field, n, cap,
                                                    monkeypatch):
    """ntt / intt / coset_eval_from_coeffs through the four-step, whose
    every level opens with the fused first leaf: the leaf cap forced to 32
    (two or three levels) and the default cap (one level at n = 8192),
    against sandstorm_tpu.ntt on inputs from a seed."""
    F, JF, ints = ((GL, JGL, _gl_ints) if field == "gl"
                   else (GL3, JG3, _gl3_ints))
    leaf, fused, default_cap = ntt_cuda.LEAVES["goldilocks"]
    assert fused is ntt_cuda.gl_ntt_leaf_fused and default_cap < 8192
    if cap is not None:
        monkeypatch.setitem(ntt_cuda.LEAVES, "goldilocks", (leaf, fused, cap))
    ja, ta = _both(F, JF, ints(n + (cap or 0), n))
    assert _agree(jax_ntt(JF, ja), ntt(F, ta))
    assert _agree(jax_ntt(JF, ja, inverse=True), intt(F, ta))
    assert _agree(jax_coset_eval(JF, ja, 2 * n, JF.GENERATOR),
                  coset_eval_from_coeffs(F, ta, 2 * n, F.GENERATOR))
