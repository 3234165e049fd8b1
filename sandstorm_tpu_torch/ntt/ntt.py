"""Radix-2 NTT, inverse NTT and coset evaluation over field tensors.

Conventions (as in sandstorm_tpu/ntt/ntt.py): arrays are [n, ..., L] with
the element index first and L the field's words per element, natural
evaluation order (index i holds the value at w^i, or c*w^i on a coset).
The transforms run through the four-step decomposition and the field's
leaf kernel (ntt_cuda.py) for every power-of-two length; a GF(p^3) array
transforms as three Goldilocks arrays.  Under an active mesh
(parallel/runtime.py) a transform the mesh divides runs as the four-step
exchange NTT (parallel/dist.py) and comes back to the input's device.
"""

import functools

import numpy as np
import torch

from .. import _tables


def bit_reverse_perm(n: int) -> np.ndarray:
    """Bit-reversal permutation indices for size-n (power of two)."""
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


@functools.lru_cache(maxsize=256)
def powers_host(F, base: int, count: int):
    """numpy [count, L] elements base^0 .. base^(count-1) (F's encoding)."""
    vals = [1] * count
    x = 1
    for i in range(1, count):
        x = F.host_mul(x, base)
        vals[i] = x
    return F.encode_ints_np(vals)


def powers_dev(F, base: int, count: int, device, start: int = 1):
    """[count, L] tensor of start * base^i on `device`: two host tables of
    about sqrt(count) powers and one broadcast multiply on the device."""
    b = 1 << ((max(count - 1, 1).bit_length() + 1) // 2)
    a = -(-count // b)
    lo = torch.from_numpy(powers_host(F, base, b).copy()).to(device)
    hi = powers_host(F, pow(base, b, F.BASE_MODULUS), a)
    hi = F.mul(torch.from_numpy(hi.copy()).to(device),
               F.encode_int(start, device))
    return F.mul(hi[:, None], lo[None, :]).reshape(a * b, F.NLIMBS)[:count] \
        .contiguous()


def ntt(F, a, inverse: bool = False):
    """In-order NTT along axis 0 of an [n, ..., L] tensor; the inverse
    includes the 1/n scale."""
    from ..parallel import runtime
    from .ntt_cuda import batched_ntt, transform_field
    n = a.shape[0]
    assert n & (n - 1) == 0, "size must be a power of two"
    if n == 1:
        return a
    mesh = runtime.active_mesh()
    if mesh is not None and runtime.four_step_ok(n, mesh):
        from ..parallel.dist import dist_ntt, gather
        return gather(dist_ntt(F, mesh, a, inverse), mesh, a.device)
    T = transform_field(F)
    out = batched_ntt(T, a.reshape(n, -1, T.NLIMBS), inverse).reshape(a.shape)
    if inverse:
        out = F.mul(out, F.encode_int(pow(n, -1, F.BASE_MODULUS), a.device))
    return out


def intt(F, a):
    return ntt(F, a, inverse=True)


def coset_powers(F, coset: int, n: int, device):
    """Cached [n, L] table of coset^i."""
    return _tables.device_table(f"pow:{F.NAME}:{coset}", n, device,
                                lambda: powers_dev(F, coset, n, device))


def coset_eval_from_coeffs(F, coeffs, N: int, coset: int):
    """Evaluate polynomials (coefficients [n, ..., L]) on {coset * w_N^i}."""
    n = coeffs.shape[0]
    assert N >= n
    pw = coset_powers(F, coset, n, coeffs.device)
    scaled = F.mul(coeffs, pw.reshape((n,) + (1,) * (coeffs.dim() - 2)
                                      + (F.NLIMBS,)))
    if N > n:
        scaled = torch.cat([scaled, torch.zeros(
            (N - n,) + tuple(scaled.shape[1:]), dtype=scaled.dtype,
            device=scaled.device)], dim=0)
    return ntt(F, scaled)
