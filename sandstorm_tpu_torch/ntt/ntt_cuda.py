"""The NTT leaf kernel (csrc/ntt.cu) and the four-step split around it.

    n = R * C, input index j = r*C + c, output index k = k_c*R + k_r:
      1. C transforms of length R over the rows (leaf kernel, recursing when
         R > M_MAX)
      2. elementwise twiddle by w_n^(k_r * c) (the montmul kernel)
      3. transpose, then R transforms of length C (leaf kernel)

The JAX package (sandstorm_tpu/ntt/ntt_pallas.py) takes this path only for
n >= 4096 on a TPU; here every power-of-two n >= 2 goes through it, so the
smallest proofs exercise the same kernels as the largest.  Columns share
one transform on the batch axis: x is [M, B, 8] with B the batch.
"""

import torch

from .. import _native, _tables
from ..fields.fp252_cuda import add_plain, mul_plain, sub_plain
from .ntt import bit_reverse_perm, powers_dev

# leaf length cap: M elements x 32 B of shared memory per block (64 KB)
M_MAX = 2048


def _root(F, M: int, inverse: bool) -> int:
    w = F.root_of_unity_int(M)
    return pow(w, -1, F.BASE_MODULUS) if inverse else w


def stage_table(F, M: int, inverse: bool, device):
    """[M/2, 8] table of w_M^k (w_M^-k when inverse), Montgomery."""
    return _tables.device_table(
        f"ntt_tw:{F.NAME}:{int(inverse)}", M, device,
        lambda: powers_dev(F, _root(F, M, inverse), M // 2, device))


def _rc_twiddle(F, M: int, R: int, inverse: bool, device):
    """[R, C, 1, 8] table of w_M^(r*c) for the four-step."""
    C = M // R

    def build():
        wp = powers_dev(F, _root(F, M, inverse), M, device)
        r = torch.arange(R, dtype=torch.int64, device=device)
        c = torch.arange(C, dtype=torch.int64, device=device)
        return wp[(r[:, None] * c[None, :]) % M].reshape(R, C, 1, 8)

    return _tables.device_table(f"ntt_rc:{F.NAME}:{int(inverse)}:{R}", M,
                                device, build)


def ntt_leaf_plain(x, tw):
    """Plain twin of the leaf kernel: NTT along axis 0 of x [M, B, 8]
    (natural order in and out) with tw = stage_table(M)."""
    M = x.shape[0]
    logM = M.bit_length() - 1
    rev = torch.from_numpy(bit_reverse_perm(M).astype("int64")).to(x.device)
    x = x[rev]
    rest = x.shape[1:-1]
    for s in range(1, logM + 1):
        half = 1 << (s - 1)
        v = x.reshape((M // (2 * half), 2 * half) + rest + (8,))
        top, bot = v[:, :half], v[:, half:]
        k = torch.arange(half, device=x.device) * (M >> s)
        w = tw[k].reshape((1, half) + (1,) * len(rest) + (8,))
        t = mul_plain(bot, w)
        x = torch.cat([add_plain(top, t), sub_plain(top, t)],
                      dim=1).reshape(x.shape)
    return x


def ntt_leaf(x, tw):
    """NTT along axis 0 of x [M, B, 8] (M a power of two <= M_MAX)."""
    if x.device.type == "cpu":
        return ntt_leaf_plain(x, tw)
    M, B = x.shape[0], x.shape[1]
    logM = M.bit_length() - 1
    if M < 2 or M & (M - 1) or M > M_MAX or x.dim() != 3:
        raise ValueError(f"ntt_leaf: bad shape {tuple(x.shape)}")
    if tw.shape != (M // 2, 8) or tw.device != x.device:
        raise ValueError(f"ntt_leaf: bad twiddle table {tuple(tw.shape)}")
    _native.check_cuda_tensor(x, "ntt_leaf x", last_dim=8)
    _native.check_cuda_tensor(tw, "ntt_leaf tw", last_dim=8)
    out = torch.empty_like(x)
    _native.launch("ntt_leaf", x.device, x.data_ptr(), out.data_ptr(),
                   tw.data_ptr(), logM, B)
    return out


def batched_ntt(F, x, inverse: bool, m_max: int = M_MAX):
    """Unscaled NTT along axis 0 of [M, B, 8] (natural in / natural out)."""
    M, B = x.shape[0], x.shape[1]
    if M <= m_max:
        return ntt_leaf(x.contiguous(), stage_table(F, M, inverse, x.device))
    # balanced split keeps both leaf lengths near sqrt(M)
    R = min(m_max, 1 << ((M.bit_length() - 1 + 1) // 2))
    C = M // R
    x = batched_ntt(F, x.reshape(R, C * B, 8), inverse, m_max)   # [k_r, (c, B)]
    x = F.mul(x.reshape(R, C, B, 8), _rc_twiddle(F, M, R, inverse, x.device))
    x = x.transpose(0, 1).contiguous().reshape(C, R * B, 8)
    x = batched_ntt(F, x, inverse, m_max)                        # [k_c, (k_r, B)]
    return x.reshape(C * R, B, 8)                                # k = k_c*R + k_r


def batched_ntt_cols(F, cols, inverse: bool):
    """Unscaled NTT over axis 0 of each same-length [n, 8] column, as one
    transform with the columns on the batch axis; returns the list."""
    out = batched_ntt(F, torch.stack(cols, dim=1), inverse)
    return list(out.unbind(1))
