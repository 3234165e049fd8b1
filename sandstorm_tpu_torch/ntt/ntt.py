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

from .. import _tables, telemetry


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
    lo = telemetry.to_device(powers_host(F, base, b).copy(), device,
                             "powers")
    hi = powers_host(F, pow(base, b, F.BASE_MODULUS), a)
    hi = F.mul(telemetry.to_device(hi.copy(), device, "powers"),
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
        out = scale_pad(F, out, n, factor=pow(n, -1, F.BASE_MODULUS))
    return out


def intt(F, a):
    return ntt(F, a, inverse=True)


def coset_powers(F, coset: int, n: int, device):
    """Cached [n, L] table of coset^i."""
    return _tables.device_table(f"pow:{F.NAME}:{coset}", n, device,
                                lambda: powers_dev(F, coset, n, device))


def scale_pad_plain(F, x, N: int, t):
    """scale_pad's plain version (CPU tensors): x [n, ..., L] times t (an
    [n, L] table broadcast over the middle dimensions, or one [L]
    element), then N - n zero rows: a field multiply, a zeros and a
    cat."""
    n = x.shape[0]
    if t.dim() == 2:
        t = t[:n].reshape((n,) + (1,) * (x.dim() - 2) + (F.NLIMBS,))
    scaled = F.mul(x, t)
    if N > n:
        scaled = torch.cat([scaled, torch.zeros(
            (N - n,) + tuple(scaled.shape[1:]), dtype=scaled.dtype,
            device=scaled.device)], dim=0)
    return scaled


def scale_pad(F, x, N: int, coset: int = None, factor: int = None):
    """[n, ..., L] x -> [N, ..., L]: row i < n is x's row i times coset^i
    (the coset powers) or times the base-field value `factor`, rows n ..
    N - 1 zero (the JAX package's _scale_pad, stark/prover.py:140; N = n
    for a scale alone).  CPU tensors take scale_pad_plain; a CUDA tensor
    one launch of its field's kernel (csrc/scale_pad.cu,
    field_cuda.scale_pad_launch), which reads the transform field's
    coset powers (over GF(p^3) Goldilocks', one word a row) or takes the
    factor by value, and writes the pad: no zeros, no cat."""
    n = x.shape[0]
    assert N >= n and (coset is None) != (factor is None)
    device = x.device
    if device.type == "cpu":
        t = (coset_powers(F, coset, n, device) if coset is not None
             else F.encode_int(factor, device))
        return scale_pad_plain(F, x, N, t)
    from ..fields.field_cuda import scale_pad_launch
    from .ntt_cuda import transform_field
    T = transform_field(F)
    if coset is not None:
        return scale_pad_launch(x, N, table=coset_powers(T, coset, n, device))
    return scale_pad_launch(x, N, factor=T.encode_ints_np([factor])[0])


def coset_eval_from_coeffs(F, coeffs, N: int, coset: int):
    """Evaluate polynomials (coefficients [n, ..., L]) on {coset * w_N^i}:
    the coset scale and zero pad (scale_pad), then the transform."""
    return ntt(F, scale_pad(F, coeffs, N, coset=coset))
