"""Prefix scans of field arrays (running products, the affine recurrence of
the recursive layout's diluted aggregate), and what is built from them.

prefix_scan is a Hillis-Steele inclusive scan: log2(n) stages, stage s
combining every row k >= 2^s with row k - 2^s, each stage one call of the
combine (for a running product one elementwise multiply: the field's
multiply kernel on a CUDA tensor).  n log n combines instead of the 2n of
a work-efficient scan, but every stage is one full-width launch of each of
its field ops.  An Fp252 running product takes the scan kernel instead
(fields/fp252_cuda.py scan_mul, csrc/scan.cu: three launches whatever n
is), whose plain version on CPU tensors is this prefix_scan; Goldilocks
and GF(p^3), and the affine recurrence, keep the Hillis-Steele stages on
every device.  The helpers take the field class F and work for every
field of the port (Fp252 [..., 8], GL [..., 2], GL3 [..., 6]).
"""

import torch


def prefix_scan(combine, xs, reverse: bool = False):
    """Inclusive scan of an associative `combine` along axis 0 of a tensor
    or a tuple of [n, ...] tensors.  Forward, row k becomes combine(prev,
    x[k]) over the rows before it; in reverse, combine(x[k], next) over
    the rows after it (the argument order of the JAX package's
    prefix_scan).  combine takes and returns what xs is."""
    single = torch.is_tensor(xs)
    ys = (xs,) if single else tuple(xs)
    ys = tuple(y.contiguous() for y in ys)
    n = ys[0].shape[0]
    s = 1
    while s < n:
        lo = tuple(y[:n - s] for y in ys)
        hi = tuple(y[s:] for y in ys)
        out = combine(lo[0], hi[0]) if single else combine(lo, hi)
        out = (out,) if single else tuple(out)
        if reverse:
            ys = tuple(torch.cat([o, y[n - s:]], dim=0)
                       for o, y in zip(out, ys))
        else:
            ys = tuple(torch.cat([y[:s], o], dim=0) for o, y in zip(out, ys))
        s <<= 1
    return ys[0] if single else ys


def prefix_mul(F, a, reverse: bool = False):
    """Inclusive running product of an [n, ..., L] field array along
    axis 0 (from the end when reverse)."""
    if F.NAME == "fp252":
        from .fp252_cuda import scan_mul
        return scan_mul(a, reverse)
    return prefix_scan(F.mul, a, reverse)


def batch_inv(F, a):
    """Montgomery batch inversion along axis 0: two running products and
    one inversion of the total, F.inv (zero anywhere -> all zeros, as in
    the JAX package).  An Fp252 CUDA tensor takes the scan kernel's
    exclusive forms, written at an offset of one row into buffers of n + 1
    rows, so that nothing is concatenated."""
    n = a.shape[0]
    if F.NAME == "fp252" and a.device.type == "cuda":
        from .fp252_cuda import scan_mul
        a = a.contiguous()
        buf = (n + 1,) + tuple(a.shape[1:])
        one = F.ones(a.shape[1:-1], a.device)
        pre = torch.empty(buf, dtype=a.dtype, device=a.device)
        pre[0] = one                      # pre[i] = a[0] ... a[i - 1]
        scan_mul(a, False, out=pre[1:])
        suf = torch.empty(buf, dtype=a.dtype, device=a.device)
        suf[n] = one                      # suf[i] = a[i] ... a[n - 1]
        scan_mul(a, True, out=suf[:n])
        total_inv = F.inv(pre[n:])
        return F.mul(F.mul(pre[:n], suf[1:]), total_inv)
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
