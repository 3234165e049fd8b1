"""The FRI fold, the coset scale and pad and the affine pair scan on the
CPU: each plain version against the JAX package, word for word, and a
model of each kernel's indexing (csrc/fri.cu, csrc/scale_pad.cu,
csrc/scan.cu's fp252_affine_scan) against the plain version.

- the fold (stark/fri.py fri_fold_device, its plain chain on a CPU
  tensor) against sandstorm_tpu/stark/fri.py fri_fold_device over Fp252,
  GL and GL3, f = 2, 4, 8, 16, N = 32 and 64, values p - 1 among the
  inputs; the GL3 fold against the verifier's host fold fri_fold_host;
  the kernel's order of work (one output a thread reading rows
  i + k N / f, the table at (i + k N / f) 2^s, over GF(p^3) Goldilocks'
  own table as 3 base products) in plain ops;
- the coset scale and pad (ntt/ntt.py scale_pad) against
  sandstorm_tpu/stark/prover.py _scale_pad per field, with the coset
  powers and with a scalar, no pad and N - n pad rows, on [n, C, L]; the
  kernel's strided read of a view (fields/field_cuda.py _strided's
  strides) in plain ops;
- the affine pair scan (fields/scan.py affine_scan) against the JAX
  prefix_scan with the layouts' compose plus the leading one, at 1, 2,
  37 and 64 rows (the model of the kernel's tiles:
  tests/test_torch_scan_fold_redesign.py);
- on a tensor that is not on the CPU, each entry takes its kernel or
  raises: no plain chain.

The kernels themselves run on the card: tests/test_torch_cuda.py and
chip_smoke.py hold them to these plain versions there.  Tolerance 0: the
arithmetic is exact.
"""

import random

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
from sandstorm_tpu_torch.fields.scan import affine_scan, compose_maps
from sandstorm_tpu_torch.interop import from_jax_digits, to_jax_digits
from sandstorm_tpu_torch.ntt import coset_powers, powers_dev, scale_pad
from sandstorm_tpu_torch.ntt.ntt import scale_pad_plain
from sandstorm_tpu_torch.ntt.ntt_cuda import transform_field
from sandstorm_tpu_torch.stark.fri import (fold_scalars, fri_fold_device,
                                           fri_fold_host)

CPU = torch.device("cpu")
FIELDS = {"fp252": (TF, JF), "goldilocks": (GL, JGL), "gl3": (GL3, JG3)}


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


# -- the FRI fold -------------------------------------------------------------

def _fold_case(name, N, f):
    F, JFd = FIELDS[name]
    rng = random.Random(N * 100 + f)
    vals = _vals(F, rng, N)
    coset = pow(F.GENERATOR, 5, F.BASE_MODULUS)
    beta = rng.randrange(2, F.MODULUS)
    return F, JFd, F.encode_ints(vals, CPU), vals, coset, beta


@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("f", [2, 4, 8, 16])
@pytest.mark.parametrize("name", ["fp252", "goldilocks", "gl3"])
def test_fri_fold_matches_jax(monkeypatch, name, f, N):
    from sandstorm_tpu.stark import fri as jax_fri
    from sandstorm_tpu.stark.fri import fri_fold_device as jax_fold
    if name == "gl3":
        # the JAX package's jitted _fold_halvings over GF(p^3) compiles for
        # many minutes on XLA:CPU (the pathology its XLA_FUSE_SAFE flag
        # answers elsewhere): its body runs eagerly, each field op its own
        # cached jit
        monkeypatch.setattr(jax_fri, "_fold_halvings",
                            jax_fri._fold_halvings.__wrapped__)
    F, JFd, x, _, coset, beta = _fold_case(name, N, f)
    got = fri_fold_device(F, x, coset, N, f, beta)
    assert got.shape == (N // f, F.NLIMBS)
    want = jax_fold(JFd, _to_jax(F, x), coset, N, f, beta)
    assert torch.equal(got, _from_jax(F, want))


def _fold_model(F, x, coset, N, f, beta):
    """csrc/fri.cu's fold_kernel in plain ops: output i of M = N / f reads
    rows i + k M (k < f) into v[k]; halving s (h = f / 2^(s+1)) sets
    v[k] = (v[k] + v[k + h]) + scale(v[k] - v[k + h], xinv[(i + k M) 2^s])
    * scal_s for k < h, with the transform field's table (over GF(p^3)
    Goldilocks', applied coordinatewise: GL3F::scale) and the scalars the
    launch passes by value (field_cuda.fold_launch's words)."""
    M = N // f
    T = transform_field(F)
    w_inv = pow(F.root_of_unity_int(N), -1, F.BASE_MODULUS)
    xinv = powers_dev(T, w_inv, N // 2, CPU)
    scals = torch.from_numpy(F.encode_ints_np(fold_scalars(F, coset, f,
                                                           beta)).copy())
    add, sub, mul = (gl_cuda.plain_ops(F.NLIMBS) if F.NLIMBS != 8 else
                     (fp252_cuda.add_plain, fp252_cuda.sub_plain,
                      fp252_cuda.mul_plain))

    def scale(d, xi):           # d [M, L], xi [M, Lx]: a base multiplier
        if F.NLIMBS == 6:
            return gl_cuda.mul_plain(d.reshape(M, 3, 2),
                                     xi[:, None, :]).reshape(M, 6)
        return mul(d, xi)

    i = torch.arange(M)
    v = [x[i + k * M] for k in range(f)]
    for s in range(f.bit_length() - 1):
        h = f >> (s + 1)
        for k in range(h):
            xi = xinv[(i + k * M) << s][:, :T.NLIMBS]
            d = sub(v[k], v[k + h])
            v[k] = add(add(v[k], v[k + h]), mul(scale(d, xi), scals[s]))
    return v[0]


@pytest.mark.parametrize("f", [2, 4, 8, 16])
@pytest.mark.parametrize("name", ["fp252", "goldilocks", "gl3"])
def test_fold_kernel_model_matches_plain(name, f):
    N = 64
    F, _, x, _, coset, beta = _fold_case(name, N, f)
    assert torch.equal(_fold_model(F, x, coset, N, f, beta),
                       fri_fold_device(F, x, coset, N, f, beta))


@pytest.mark.parametrize("f", [2, 4, 8])
def test_gl3_fold_matches_host_fold(f):
    """The GF(p^3) fold against the verifier's host fold of each row (the
    extension values through Fq3S, the domain base-field)."""
    N = 32
    F, _, x, vals, coset, beta = _fold_case("gl3", N, f)
    folded = F.decode_ints(fri_fold_device(F, x, coset, N, f, beta))
    p = F.BASE_MODULUS
    w = F.root_of_unity_int(N)
    for i in range(N // f):
        row = [F.s(vals[t * (N // f) + i]) for t in range(f)]
        host = fri_fold_host(p, row, i, N, coset, w, f, F.s(beta))
        assert folded[i] == int(F.s(host))


# -- the coset scale and pad ----------------------------------------------------

@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("kind", ["table", "scalar"])
@pytest.mark.parametrize("name", ["fp252", "goldilocks", "gl3"])
def test_scale_pad_matches_jax(name, kind, pad):
    from sandstorm_tpu.ntt.ntt import powers_host as jax_powers
    from sandstorm_tpu.stark.prover import _scale_pad
    F, JFd = FIELDS[name]
    n, C = 16, 3
    N = 2 * n if pad else n
    rng = random.Random(7 + 2 * pad + (kind == "scalar"))
    x = F.encode_ints(_vals(F, rng, n * C), CPU).reshape(n, C, F.NLIMBS)
    p = F.BASE_MODULUS
    if kind == "table":
        coset = pow(F.GENERATOR, 3, p)
        got = scale_pad(F, x, N, coset=coset)
        scale = jnp.asarray(jax_powers(JFd, coset, n))[:, None]
    else:
        factor = pow(n, -1, p)
        got = scale_pad(F, x, N, factor=factor)
        scale = JFd.encode_int(factor)
    want = _scale_pad(JFd, _to_jax(F, x), scale, N - n)
    assert got.shape == (N, C, F.NLIMBS)
    assert torch.equal(got, _from_jax(F, want))
    assert not got[n:].any()


@pytest.mark.parametrize("name", ["fp252", "goldilocks", "gl3"])
def test_scale_pad_kernel_model_on_a_view(name):
    """csrc/scale_pad.cu's indexing in plain ops on a strided view (the
    columns of a transposed stack, as intt's reshape hands over): output
    element e of [N, C] is row e / C, column e % C, read at word i rs + c
    cs of the view's storage with fields/field_cuda.py _strided's strides,
    times the transform field's coset power (over GF(p^3) one Goldilocks
    word a row), zero past row n."""
    F, _ = FIELDS[name]
    n, C, N = 8, 5, 32
    L = F.NLIMBS
    rng = random.Random(11)
    base = F.encode_ints(_vals(F, rng, n * C), CPU).reshape(C, n, L)
    x = base.transpose(0, 1)                      # [n, C, L], not contiguous
    v, rs, cs = field_cuda._strided(x, 16 if L == 8 else 8)
    assert v.data_ptr() == x.data_ptr() and (rs, cs) == (L, n * L)
    coset = pow(F.GENERATOR, 7, F.BASE_MODULUS)
    T = transform_field(F)
    table = coset_powers(T, coset, n, CPU)
    storage = base.reshape(-1)                    # x's storage
    mul = (fp252_cuda.mul_plain if L == 8 else gl_cuda.mul_plain)
    out = torch.zeros((N * C, L), dtype=torch.int32)
    for e in range(n * C):
        i, c = divmod(e, C)
        at = i * rs + c * cs
        elem = storage[at:at + L]
        xi = table[i, :T.NLIMBS]
        out[e] = (mul(elem.reshape(3, 2), xi).reshape(6) if L == 6
                  else mul(elem, xi))
    want = scale_pad(F, x, N, coset=coset)
    assert torch.equal(out.reshape(N, C, L), want)
    assert torch.equal(want, scale_pad_plain(
        F, x, N, coset_powers(F, coset, n, CPU)))


# -- the affine pair scan -------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 37, 64])
def test_affine_scan_matches_jax(n):
    from sandstorm_tpu.fields.scan import prefix_scan as jax_scan
    rng = random.Random(n)
    a = TF.encode_ints(_vals(TF, rng, n), CPU)
    b = TF.encode_ints(_vals(TF, rng, n)[::-1], CPU)
    got = affine_scan(TF, a, b)
    ja, jb = jax_scan(compose_maps(JF), (_to_jax(TF, a), _to_jax(TF, b)))
    want = jnp.concatenate([JF.ones((1,)), JF.add(ja, jb)], axis=0)
    assert got.shape == (n + 1, 8)
    assert torch.equal(got, _from_jax(TF, want))


# -- no plain chain off the CPU -------------------------------------------------

def test_entries_off_the_cpu_take_the_kernel_or_raise():
    """A tensor on another device than the CPU (here "meta": no card in
    this process) goes to the launch wrappers, which refuse it, and never
    to the plain chains; the affine scan has no kernel outside Fp252."""
    meta = torch.device("meta")
    x = torch.empty((64, 8), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fri_fold_device(TF, x, TF.GENERATOR, 64, 8, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scale_pad(TF, x, 128, factor=3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        affine_scan(TF, x, x)
    g = torch.empty((64, 2), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        affine_scan(GL, g, g)
    with pytest.raises(ValueError, match="stages"):
        field_cuda.fold_launch(x, x, np.zeros((5, 8), np.int32))
