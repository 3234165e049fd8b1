"""The NTT leaf kernels (csrc/ntt.cu for Fp252, csrc/gl_ntt.cu for
Goldilocks) and the four-step split around them.

    n = R * C, input index j = r*C + c, output index k = k_c*R + k_r:
      1. C transforms of length R over the rows (leaf kernel, recursing when
         R > the field's leaf cap)
      2. elementwise twiddle by w_n^(k_r * c) (the field's multiply kernel)
      3. transpose, then R transforms of length C (leaf kernel)

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

# leaf length caps: M elements of shared memory per block, 64 KB for both
M_MAX = 2048        # Fp252, 32 B per element
GL_M_MAX = 8192     # Goldilocks, 8 B per element


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


def _leaf(entry, L, m_max, plain_ops, x, tw):
    if x.device.type == "cpu":
        return ntt_leaf_plain(x, tw, plain_ops)
    M, B = x.shape[0], x.shape[1]
    logM = M.bit_length() - 1
    if M < 2 or M & (M - 1) or M > m_max or x.dim() != 3:
        raise ValueError(f"{entry}: bad shape {tuple(x.shape)}")
    if tw.shape != (M // 2, L) or tw.device != x.device:
        raise ValueError(f"{entry}: bad twiddle table {tuple(tw.shape)}")
    align = 16 if L == 8 else 8
    _native.check_cuda_tensor(x, f"{entry} x", last_dim=L, align=align)
    _native.check_cuda_tensor(tw, f"{entry} tw", last_dim=L, align=align)
    out = torch.empty_like(x)
    _native.launch(entry, x.device, x.data_ptr(), out.data_ptr(),
                   tw.data_ptr(), logM, B)
    return out


def ntt_leaf(x, tw):
    """Fp252 NTT along axis 0 of x [M, B, 8] (M a power of two <= M_MAX)."""
    return _leaf("ntt_leaf", 8, M_MAX, fp252_cuda.PLAIN, x, tw)


def gl_ntt_leaf(x, tw):
    """Goldilocks NTT along axis 0 of x [M, B, 2] (M a power of two <=
    GL_M_MAX)."""
    return _leaf("gl_ntt_leaf", 2, GL_M_MAX, gl_cuda.PLAIN, x, tw)


# field name -> (leaf, its length cap)
LEAVES = {"fp252": (ntt_leaf, M_MAX), "goldilocks": (gl_ntt_leaf, GL_M_MAX)}


def batched_ntt(F, x, inverse: bool, m_max: int = None):
    """Unscaled NTT along axis 0 of [M, B, L] (natural in / natural out);
    F is Fp252 or GL.  m_max caps the leaf length (default: the leaf's)."""
    leaf, cap = LEAVES[F.NAME]
    m_max = cap if m_max is None else m_max
    M, B, L = x.shape
    if M <= m_max:
        return leaf(x.contiguous(), stage_table(F, M, inverse, x.device))
    # balanced split keeps both leaf lengths near sqrt(M)
    R = min(m_max, 1 << ((M.bit_length() - 1 + 1) // 2))
    C = M // R
    x = batched_ntt(F, x.reshape(R, C * B, L), inverse, m_max)  # [k_r, (c, B)]
    x = F.mul(x.reshape(R, C, B, L), _rc_twiddle(F, M, R, inverse, x.device))
    x = x.transpose(0, 1).contiguous().reshape(C, R * B, L)
    x = batched_ntt(F, x, inverse, m_max)                     # [k_c, (k_r, B)]
    return x.reshape(C * R, B, L)                             # k = k_c*R + k_r


def transform_field(F):
    """The field whose transform carries F's arrays: GF(p^3) transforms as
    Goldilocks, a [n, ..., 6] array as [n, 3 ..., 2] (the NTT is linear over
    the base field and its twiddles are base-field: the JAX package's
    _gl3_view, ntt_pallas.py:205)."""
    return GL if F.NAME == "gl3" else F


def batched_ntt_cols(F, cols, inverse: bool):
    """Unscaled NTT over axis 0 of each same-length [n, L] column, as one
    transform with the columns on the batch axis; returns the list."""
    T = transform_field(F)
    x = torch.stack(cols, dim=1)
    out = batched_ntt(T, x.reshape(x.shape[0], -1, T.NLIMBS), inverse)
    return list(out.reshape(x.shape).unbind(1))
