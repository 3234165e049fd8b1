"""Goldilocks kernels (csrc/goldilocks.cu) and their plain PyTorch twins.

An element of GF(p), p = 2^64 - 2^32 + 1, is a ``[..., 2]`` int32 tensor
holding the (lo, hi) u32 words of its canonical value; an element of
GF(p^3) = GF(p)[x] / (x^3 - 2) is a ``[..., 6]`` tensor of three such
coordinates.  Each public function takes the plain version for CPU tensors
and launches its CUDA kernel for CUDA tensors; a CUDA launch that fails
raises.

The plain versions compute in int64 carriers on u32 words and mask after
every step: PyTorch's CPU backend has no unsigned 64-bit arithmetic.  They
mirror the JAX package's gl_mul_tile / gl_add_tile / gl_sub_tile
(fields/gl_pallas.py:29-51) and GL.reduce128 (fields/goldilocks.py:147)
step by step; the 64 x 64-bit product is taken on 16-bit digits, whose
partial products fit a signed int64.
"""

import torch

from .fp252_cuda import launch_elementwise

P = (1 << 64) - (1 << 32) + 1
NR = 2                      # x^3 = NR in GF(p^3)

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF
EPS = _M32                  # 2^64 mod p


# -- plain versions ---------------------------------------------------------

def _words(x):
    """int32 [..., 2] -> (lo, hi) int64 tensors holding the u32 values."""
    w = x.to(torch.int64) & _M32
    return w[..., 0], w[..., 1]


def _pack(lo, hi):
    """(lo, hi) int64 tensors (values < 2^32) -> int32 [..., 2]."""
    w = torch.stack([lo, hi], dim=-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _add64(alo, ahi, blo, bhi):
    """(a + b) mod 2^64 as (lo, hi) and the carry out (0 or 1)."""
    t = alo + blo
    lo, c = t & _M32, t >> 32
    t = ahi + bhi + c
    return lo, t & _M32, t >> 32


def _sub64(alo, ahi, blo, bhi):
    """(a - b) mod 2^64 as (lo, hi) and the borrow out (0 or 1)."""
    t = alo - blo
    lo, br = t & _M32, (t >> 63) & 1
    t = ahi - bhi - br
    return lo, t & _M32, (t >> 63) & 1


def _cond_sub_p(lo, hi):
    """A value below 2p (as 64 bits) -> the value mod p."""
    dlo, dhi, br = _sub64(lo, hi, 1, _M32)
    keep = br.bool()
    return torch.where(keep, lo, dlo), torch.where(keep, hi, dhi)


def _mul_wide(alo, ahi, blo, bhi):
    """The 128-bit product as four u32 words, least significant first."""
    ad = [alo & _M16, alo >> 16, ahi & _M16, ahi >> 16]
    bd = [blo & _M16, blo >> 16, bhi & _M16, bhi >> 16]
    # digit convolution: products < 2^32, at most 4 terms per digit
    digits, carry = [], 0
    for k in range(8):
        t = carry
        for i in range(max(0, k - 3), min(k, 3) + 1):
            t = t + ad[i] * bd[k - i]
        digits.append(t & _M16)
        carry = t >> 16
    return [digits[2 * k] | (digits[2 * k + 1] << 16) for k in range(4)]


def _reduce128(w0, w1, w2, w3):
    """x = w0 + w1 2^32 + w2 2^64 + w3 2^96 mod p, with 2^64 = 2^32 - 1 and
    2^96 = -1: (lo - w3) + w2 (2^32 - 1), borrow and carry folded."""
    zero = torch.zeros_like(w0)
    t_lo, t_hi, br = _sub64(w0, w1, w3, zero)
    t_lo, t_hi, _ = _sub64(t_lo, t_hi, br * EPS, zero)
    # w2 * (2^32 - 1) = w2 * 2^32 - w2
    t1_lo, t1_hi, _ = _sub64(zero, w2, w2, zero)
    r_lo, r_hi, c = _add64(t_lo, t_hi, t1_lo, t1_hi)
    r_lo, r_hi, _ = _add64(r_lo, r_hi, c * EPS, zero)
    return _cond_sub_p(r_lo, r_hi)


def add_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    alo, ahi = _words(a)
    blo, bhi = _words(b)
    lo, hi, c = _add64(alo, ahi, blo, bhi)
    lo, hi, _ = _add64(lo, hi, c * EPS, torch.zeros_like(c))
    return _pack(*_cond_sub_p(lo, hi))


def sub_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    alo, ahi = _words(a)
    blo, bhi = _words(b)
    lo, hi, br = _sub64(alo, ahi, blo, bhi)
    lo, hi, _ = _sub64(lo, hi, br * EPS, torch.zeros_like(br))
    return _pack(lo, hi)


def mul_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return _pack(*_reduce128(*_mul_wide(*_words(a), *_words(b))))


PLAIN = {"add": add_plain, "sub": sub_plain, "mul": mul_plain}


def gl3_mul_plain(a, b):
    """GF(p^3) product of [..., 6] tensors: GL3.mul of the JAX package
    (fields/gl3.py:284), 9 base multiplies and the x^3 = 2 reduction,
    through the plain GL ops."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a[..., 0:2], a[..., 2:4], a[..., 4:6]
    b0, b1, b2 = b[..., 0:2], b[..., 2:4], b[..., 4:6]
    M, A = mul_plain, add_plain
    nr = torch.tensor([NR, 0], dtype=torch.int32, device=a.device)
    d0 = M(a0, b0)
    d1 = A(M(a0, b1), M(a1, b0))
    d2 = A(A(M(a0, b2), M(a1, b1)), M(a2, b0))
    d3 = A(M(a1, b2), M(a2, b1))
    d4 = M(a2, b2)
    return torch.cat([A(d0, M(d3, nr)), A(d1, M(d4, nr)), d2], dim=-1)


# -- the kernels ------------------------------------------------------------

def binop(op: str, a, b):
    """Goldilocks `op` ('add' | 'sub' | 'mul') of broadcastable [..., 2]
    int32 tensors; both on the CPU (plain version) or both on one CUDA
    device."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return PLAIN[op](a, b)
    return launch_elementwise(f"gl_{op}", a, b, 2, 8)


def gl3_mul(a, b):
    """GF(p^3) product of broadcastable [..., 6] int32 tensors: one launch
    of csrc/goldilocks.cu's gl3_mul on a CUDA device."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gl3_mul_plain(a, b)
    return launch_elementwise("gl3_mul", a, b, 6, 8)
