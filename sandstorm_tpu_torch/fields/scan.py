"""Running products of field arrays, and what is built from them.

A Hillis-Steele inclusive scan: log2(n) stages, stage s multiplying every
row k >= 2^s by row k - 2^s, each stage one elementwise multiply (the
field's multiply kernel on a CUDA tensor).  n log n multiplies instead of
the 2n of a work-efficient scan, but every stage is one full-width launch.
The helpers here take the field class F and work for every field of the
port (Fp252 [..., 8], GL [..., 2], GL3 [..., 6]).
"""

import torch


def prefix_mul(F, a, reverse: bool = False):
    """Inclusive running product of an [n, ..., L] field array along
    axis 0 (from the end when reverse)."""
    if reverse:
        return prefix_mul(F, a.flip(0)).flip(0)
    y = a.contiguous()
    n = y.shape[0]
    s = 1
    while s < n:
        y = torch.cat([y[:s], F.mul(y[:n - s], y[s:])], dim=0)
        s <<= 1
    return y


def batch_inv(F, a):
    """Montgomery batch inversion along axis 0: two running products and
    one inversion of the total, F.inv (zero anywhere -> all zeros, as in
    the JAX package)."""
    n = a.shape[0]
    prefix = prefix_mul(F, a)
    total_inv = F.inv(prefix[n - 1:n])
    suffix = prefix_mul(F, a, reverse=True)
    ones = F.ones((1,) + tuple(a.shape[1:-1]), a.device)
    prefix_shift = torch.cat([ones, prefix[:n - 1]], dim=0)
    suffix_shift = torch.cat([suffix[1:], ones], dim=0)
    return F.mul(F.mul(prefix_shift, suffix_shift), total_inv)


def pow_static(F, a, e: int):
    """a^e for a python-int exponent (square and multiply)."""
    if e == 0:
        return F.ones(a.shape[:-1], a.device).contiguous()
    result, base = None, a
    while e:
        if e & 1:
            result = base if result is None else F.mul(result, base)
        e >>= 1
        if e:
            base = F.mul(base, base)
    return result
