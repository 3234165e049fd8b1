"""Fp252 kernels (csrc/fp252.cu, csrc/open_pairs.cu) and their plain
PyTorch twins.

An element is a ``[..., 8]`` int32 tensor holding the u32 limbs of its
Montgomery form (R = 2^256).  Each public function takes the plain version
for CPU tensors and launches its CUDA kernel for CUDA tensors; a CUDA launch
that fails raises.

The plain versions compute in int64 carriers and mask after every shift:
PyTorch's CPU backend has no add, shift or compare on uint32.  A 32x32-bit
product overflows signed int64, so the plain multiply works on sixteen
16-bit digits, as the JAX package's fields/fp252.py (_dmul_loose, _redc)
does.
"""

import math

import torch

from .. import _native

P = (1 << 251) + 17 * (1 << 192) + 1
P_WORDS = [(P >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
assert P_WORDS == [1, 0, 0, 0, 0, 0, 17, 1 << 27]

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF


# -- plain versions ---------------------------------------------------------

def _words(x):
    """int32 [..., 8] -> list of 8 int64 tensors holding the u32 values."""
    w = x.to(torch.int64) & _M32
    return [w[..., k] for k in range(8)]


def _pack(words):
    """list of 8 int64 tensors (values < 2^32) -> int32 [..., 8]."""
    w = torch.stack(words, dim=-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _cond_sub_p(s):
    """8 int64 words of a value < 2p -> the value mod p."""
    d, borrow = [], 0
    for k in range(8):
        t = s[k] - P_WORDS[k] - borrow
        d.append(t & _M32)
        borrow = (t >> 63) & 1
    keep = borrow.bool()
    return [torch.where(keep, x, y) for x, y in zip(s, d)]


def add_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    aw, bw = _words(a), _words(b)
    s, c = [], 0
    for k in range(8):
        t = aw[k] + bw[k] + c
        s.append(t & _M32)
        c = t >> 32
    return _pack(_cond_sub_p(s))


def sub_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    aw, bw = _words(a), _words(b)
    d, borrow = [], 0
    for k in range(8):
        t = aw[k] - bw[k] - borrow
        d.append(t & _M32)
        borrow = (t >> 63) & 1
    e, c = [], 0
    for k in range(8):
        t = d[k] + P_WORDS[k] + c
        e.append(t & _M32)
        c = t >> 32
    wrapped = borrow.bool()
    return _pack([torch.where(wrapped, x, y) for x, y in zip(e, d)])


def mul_plain(a, b):
    """a * b * 2^-256 mod p over 16-bit digits in int64 carriers."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape[:-1]

    def digits(x):
        w = x.to(torch.int64) & _M32
        return torch.stack([w & _M16, w >> 16], dim=-1).reshape(
            shape + (16,))

    ad, bd = digits(a), digits(b)
    # 16x16 digit convolution: products < 2^32, 16 terms per digit < 2^36
    t = torch.zeros(shape + (33,), dtype=torch.int64, device=a.device)
    for j in range(16):
        t[..., j:j + 16] += ad * bd[..., j:j + 1]
    # REDC with p's nonzero digits 1 @0, 17 @12, 0x800 @15: t stays loose
    # (< 2^40) and is normalized once at the end
    c = torch.zeros(shape, dtype=torch.int64, device=a.device)
    for i in range(16):
        ti = t[..., i] + c
        m = (-ti) & _M16
        c = (ti + m) >> 16
        t[..., i + 12] += m * 17
        t[..., i + 15] += m << 11
    out, carry = [], c
    for k in range(17):
        v = t[..., 16 + k] + carry
        out.append(v & _M16)
        carry = v >> 16
    # result < 2p < 2^253: the 17th digit is zero after propagation
    words = [out[2 * k] | (out[2 * k + 1] << 16) for k in range(8)]
    return _pack(_cond_sub_p(words))


PLAIN = {"add": add_plain, "sub": sub_plain, "mul": mul_plain}


# -- kernel 1: elementwise multiply / add / subtract -------------------------

def _operand(x, shape):
    """(tensor, div, mod) so that element i of an output of `shape` reads
    element (i // div) % mod of the returned contiguous tensor; copies x
    only when its broadcast is not of that form."""
    xs = (1,) * (len(shape) - (x.dim() - 1)) + tuple(x.shape[:-1])
    if xs == tuple(shape):
        return x.contiguous(), 1, max(math.prod(shape), 1)
    live = [d for d, s in enumerate(xs) if s != 1]
    if not live:
        return x.reshape(8).contiguous(), 1, 1
    lo, hi = live[0], live[-1]
    if all(xs[d] == shape[d] for d in range(lo, hi + 1)):
        return (x.contiguous(), math.prod(shape[hi + 1:]),
                math.prod(xs[lo:hi + 1]))
    return x.expand(tuple(shape) + (8,)).contiguous(), 1, math.prod(shape)


def binop(op: str, a, b):
    """Fp252 `op` ('add' | 'sub' | 'mul') of broadcastable [..., 8] int32
    tensors; both on the CPU (plain version) or both on one CUDA device."""
    if a.device != b.device:
        raise ValueError(f"fp252 {op}: operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return PLAIN[op](a, b)
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.empty(tuple(shape) + (8,), dtype=torch.int32, device=a.device)
    at, a_div, a_mod = _operand(a, shape)
    bt, b_div, b_mod = _operand(b, shape)
    for name, t in (("a", at), ("b", bt), ("out", out)):
        _native.check_cuda_tensor(t, f"fp252 {op} {name}", last_dim=8)
    _native.launch(f"fp252_{op}", a.device, at.data_ptr(), a_div, a_mod,
                   bt.data_ptr(), b_div, b_mod, out.data_ptr(),
                   out.numel() // 8)
    return out


# -- kernel 3: pair-indexed opener ------------------------------------------

def tree_sum_plain(x):
    """Field sum over axis 0 (power-of-two length) with plain adds."""
    while x.shape[0] > 1:
        x = add_plain(x[0::2], x[1::2])
    return x[0]


def open_pairs_plain(cols, lo, hi, kidx, cidx):
    """out[p] = sum_i cols[cidx[p], i] * hi[kidx[p], i // b] * lo[kidx[p],
    i % b] with b = lo.shape[1]; cols [C, n, 8], lo [K, b, 8],
    hi [K, n / b, 8], kidx/cidx int sequences of length P -> [P, 8]."""
    n = cols.shape[1]
    powers = {}
    out = []
    for k, c in zip(kidx, cidx):
        k, c = int(k), int(c)
        if k not in powers:
            powers[k] = mul_plain(hi[k][:, None], lo[k][None, :]).reshape(n, 8)
        out.append(tree_sum_plain(mul_plain(cols[c], powers[k])))
    return torch.stack(out)


OPEN_CHUNK = 4096  # coefficients per block of the partial-sum launch


def open_pairs(cols, lo, hi, kidx, cidx):
    """The opener on [C, n, 8] coefficient columns; see open_pairs_plain.
    kidx/cidx are int32 tensors on the columns' device."""
    if cols.device.type == "cpu":
        return open_pairs_plain(cols, lo, hi, kidx.tolist(), cidx.tolist())
    C, n, _ = cols.shape
    K, b, _ = lo.shape
    if b & (b - 1) or n % b or hi.shape != (K, n // b, 8):
        raise ValueError(f"open_pairs: bad power tables {tuple(lo.shape)}, "
                         f"{tuple(hi.shape)} for n = {n}")
    P = kidx.numel()
    if P != cidx.numel() or P > 65535:
        raise ValueError(f"open_pairs: bad pair lists ({P}, {cidx.numel()})")
    for name, t in (("cols", cols), ("lo", lo), ("hi", hi)):
        _native.check_cuda_tensor(t, f"open_pairs {name}", last_dim=8)
    for name, t in (("kidx", kidx), ("cidx", cidx)):
        _native.check_cuda_tensor(t, f"open_pairs {name}")
    nchunks = -(-n // OPEN_CHUNK)
    partial = torch.empty((P, nchunks, 8), dtype=torch.int32,
                          device=cols.device)
    out = torch.empty((P, 8), dtype=torch.int32, device=cols.device)
    _native.launch("open_pairs_partial", cols.device, cols.data_ptr(), n,
                   lo.data_ptr(), b.bit_length() - 1, hi.data_ptr(),
                   kidx.data_ptr(), cidx.data_ptr(), P, nchunks, OPEN_CHUNK,
                   partial.data_ptr())
    _native.launch("open_pairs_reduce", cols.device, partial.data_ptr(), P,
                   nchunks, out.data_ptr())
    return out
