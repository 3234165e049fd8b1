"""The NTT leaf kernels (csrc/ntt.cu for Fp252, csrc/gl_ntt.cu for
Goldilocks) and the four-step split around them.

    n = R * C, input index j = r*C + c, output index k = k_c*R + k_r:
      1. C transforms of length R over the rows (R <= the leaf cap)
      2. elementwise twiddle by w_n^(k_r * c)
      3. transpose, then R transforms of length C (recursing when C > the
         leaf cap)
Step 1, step 2 and the transpose are one launch of the field's fused leaf
(ntt_leaf_fused, gl_ntt_leaf_fused: the twiddle multiply and the transposed
store are its epilogue).

The JAX package (sandstorm_tpu/ntt/ntt_pallas.py) takes this path only for
n >= 4096 on a TPU; here every power-of-two n >= 2 goes through it, so the
smallest proofs exercise the same kernels as the largest.  Columns share
one transform on the batch axis: x is [M, B, L] with B the batch and L the
field's words per element (8 for Fp252, 2 for Goldilocks; a GF(p^3) array
transforms as Goldilocks, see ntt.py).
"""

import torch

from .. import _native, _tables
from ..fields import fp252_cuda, gl_cuda
from ..fields.goldilocks import GL
from .ntt import bit_reverse_perm, powers_dev

# leaf length caps: the longest transform a block's shared-memory tile holds
M_MAX = 2048        # Fp252: one transform of 32 B elements, 64 KB
GL_M_MAX = 2048     # Goldilocks: four adjacent transforms of 8 B elements


def _root(F, M: int, inverse: bool) -> int:
    w = F.root_of_unity_int(M)
    return pow(w, -1, F.BASE_MODULUS) if inverse else w


def stage_table(F, M: int, inverse: bool, device):
    """[M/2, L] table of w_M^k (w_M^-k when inverse), in F's mul domain."""
    return _tables.device_table(
        f"ntt_tw:{F.NAME}:{int(inverse)}", M, device,
        lambda: powers_dev(F, _root(F, M, inverse), M // 2, device))


def _rc_twiddle(F, M: int, R: int, inverse: bool, device):
    """[R, C, 1, L] table of w_M^(r*c) for the four-step."""
    C = M // R

    def build():
        wp = powers_dev(F, _root(F, M, inverse), M, device)
        r = torch.arange(R, dtype=torch.int64, device=device)
        c = torch.arange(C, dtype=torch.int64, device=device)
        return wp[(r[:, None] * c[None, :]) % M].reshape(R, C, 1, F.NLIMBS)

    return _tables.device_table(f"ntt_rc:{F.NAME}:{int(inverse)}:{R}", M,
                                device, build)


def ntt_leaf_plain(x, tw, ops=fp252_cuda.PLAIN):
    """Plain twin of the leaf kernels: NTT along axis 0 of x [M, B, L]
    (natural order in and out) with tw = stage_table(M) and the field's
    plain `ops` (fp252_cuda.PLAIN or gl_cuda.PLAIN)."""
    M, L = x.shape[0], x.shape[-1]
    logM = M.bit_length() - 1
    rev = torch.from_numpy(bit_reverse_perm(M).astype("int64")).to(x.device)
    x = x[rev]
    rest = x.shape[1:-1]
    for s in range(1, logM + 1):
        half = 1 << (s - 1)
        v = x.reshape((M // (2 * half), 2 * half) + rest + (L,))
        top, bot = v[:, :half], v[:, half:]
        k = torch.arange(half, device=x.device) * (M >> s)
        w = tw[k].reshape((1, half) + (1,) * len(rest) + (L,))
        t = ops["mul"](bot, w)
        x = torch.cat([ops["add"](top, t), ops["sub"](top, t)],
                      dim=1).reshape(x.shape)
    return x


def _twiddle_transpose(y, rc, Bi: int, mul):
    """y [M, C * Bi, L] times rc [M, C, 1, L] (w^(k c) at row k of column
    c * Bi + b) with `mul`, transposed to [C, M * Bi, L]."""
    M, Bt, L = y.shape
    y = mul(y.reshape(M, Bt // Bi, Bi, L), rc)
    return y.transpose(0, 1).contiguous().reshape(Bt // Bi, M * Bi, L)


def ntt_leaf_fused_plain(x, tw, rc, Bi: int):
    """Plain twin of ntt_leaf_fused: ntt_leaf_plain of x [M, C * Bi, 8],
    then the twiddle multiply by rc [M, C, 1, 8] and the transpose to
    [C, M * Bi, 8]."""
    return _twiddle_transpose(ntt_leaf_plain(x, tw), rc, Bi,
                              fp252_cuda.mul_plain)


def gl_ntt_leaf_fused_plain(x, tw, rc, Bi: int):
    """Plain twin of gl_ntt_leaf_fused: the same over Goldilocks, x
    [M, C * Bi, 2], rc [M, C, 1, 2] -> [C, M * Bi, 2]."""
    return _twiddle_transpose(ntt_leaf_plain(x, tw, gl_cuda.PLAIN), rc, Bi,
                              gl_cuda.mul_plain)


def _check_leaf(entry, L, m_max, x, tw):
    M = x.shape[0]
    if M < 2 or M & (M - 1) or M > m_max or x.dim() != 3:
        raise ValueError(f"{entry}: bad shape {tuple(x.shape)}")
    if tw.shape != (M // 2, L) or tw.device != x.device:
        raise ValueError(f"{entry}: bad twiddle table {tuple(tw.shape)}")
    align = 16 if L == 8 else 8
    _native.check_cuda_tensor(x, f"{entry} x", last_dim=L, align=align)
    _native.check_cuda_tensor(tw, f"{entry} tw", last_dim=L, align=align)
    return M.bit_length() - 1


def _leaf(entry, L, m_max, plain_ops, x, tw):
    if x.device.type == "cpu":
        return ntt_leaf_plain(x, tw, plain_ops)
    logM = _check_leaf(entry, L, m_max, x, tw)
    out = torch.empty_like(x)
    _native.launch(entry, x.device, x.data_ptr(), out.data_ptr(),
                   tw.data_ptr(), logM, x.shape[1])
    return out


def ntt_leaf(x, tw):
    """Fp252 NTT along axis 0 of x [M, B, 8] (M a power of two <= M_MAX)."""
    return _leaf("ntt_leaf", 8, M_MAX, fp252_cuda.PLAIN, x, tw)


def _leaf_fused(entry, L, m_max, plain, x, tw, rc, Bi: int):
    if x.device.type == "cpu":
        return plain(x, tw, rc, Bi)
    logM = _check_leaf(entry, L, m_max, x, tw)
    M, Bt, _ = x.shape
    if Bi < 1 or Bt % Bi or rc.shape != (M, Bt // Bi, 1, L) \
            or rc.device != x.device:
        raise ValueError(f"{entry}: bad twiddles {tuple(rc.shape)} "
                         f"for {tuple(x.shape)}, Bi = {Bi}")
    _native.check_cuda_tensor(rc, f"{entry} rc", last_dim=L,
                              align=16 if L == 8 else 8)
    out = torch.empty((Bt // Bi, M * Bi, L), dtype=x.dtype, device=x.device)
    _native.launch(entry, x.device, x.data_ptr(), out.data_ptr(),
                   tw.data_ptr(), rc.data_ptr(), logM, Bt, Bi)
    return out


def ntt_leaf_fused(x, tw, rc, Bi: int):
    """The first leaf of an Fp252 four-step: see ntt_leaf_fused_plain
    (x [M, C * Bi, 8], rc [M, C, 1, 8] -> [C, M * Bi, 8])."""
    return _leaf_fused("ntt_leaf_fused", 8, M_MAX, ntt_leaf_fused_plain,
                       x, tw, rc, Bi)


def gl_ntt_leaf(x, tw):
    """Goldilocks NTT along axis 0 of x [M, B, 2] (M a power of two <=
    GL_M_MAX)."""
    return _leaf("gl_ntt_leaf", 2, GL_M_MAX, gl_cuda.PLAIN, x, tw)


def gl_ntt_leaf_fused(x, tw, rc, Bi: int):
    """The first leaf of a Goldilocks four-step: see
    gl_ntt_leaf_fused_plain (x [M, C * Bi, 2], rc [M, C, 1, 2] ->
    [C, M * Bi, 2])."""
    return _leaf_fused("gl_ntt_leaf_fused", 2, GL_M_MAX,
                       gl_ntt_leaf_fused_plain, x, tw, rc, Bi)


# field name -> (leaf, four-step first leaf, the leaves' length cap)
LEAVES = {"fp252": (ntt_leaf, ntt_leaf_fused, M_MAX),
          "goldilocks": (gl_ntt_leaf, gl_ntt_leaf_fused, GL_M_MAX)}


def batched_ntt(F, x, inverse: bool, m_max: int = None):
    """Unscaled NTT along axis 0 of [M, B, L] (natural in / natural out);
    F is Fp252 or GL.  m_max caps the leaf length (default: the leaf's)."""
    leaf, first_leaf, cap = LEAVES[F.NAME]
    m_max = cap if m_max is None else m_max
    M, B, L = x.shape
    x = x.contiguous()
    if M <= m_max:
        return leaf(x, stage_table(F, M, inverse, x.device))
    # balanced split keeps both leaf lengths near sqrt(M); R <= m_max, so
    # the first step is always a single leaf
    R = min(m_max, 1 << ((M.bit_length() - 1 + 1) // 2))
    C = M // R
    x = first_leaf(x.reshape(R, C * B, L), stage_table(F, R, inverse, x.device),
                   _rc_twiddle(F, M, R, inverse, x.device), B)
    x = batched_ntt(F, x, inverse, m_max)                     # [k_c, (k_r, B)]
    return x.reshape(C * R, B, L)                             # k = k_c*R + k_r


def transform_field(F):
    """The field whose transform carries F's arrays: GF(p^3) transforms as
    Goldilocks, a [n, ..., 6] array as [n, 3 ..., 2] (the NTT is linear over
    the base field and its twiddles are base-field: the JAX package's
    _gl3_view, ntt_pallas.py:205)."""
    return GL if F.NAME == "gl3" else F

