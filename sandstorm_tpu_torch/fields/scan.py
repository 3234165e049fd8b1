"""Prefix scans of field arrays (running products, the affine recurrence of
the recursive layout's diluted aggregate), and what is built from them.

prefix_scan is a Hillis-Steele inclusive scan: log2(n) stages, stage s
combining every row k >= 2^s with row k - 2^s, each stage one call of the
combine (for a running product one elementwise multiply: the field's
multiply kernel on a CUDA tensor).  n log n combines instead of the 2n of
a work-efficient scan, but every stage is one full-width launch of each of
its field ops.  It is the plain version of the running-product kernels,
which a running product on a CUDA tensor takes in every field: Fp252's
fp252_scan_mul (csrc/scan.cu), Goldilocks' and GF(p^3)'s gl_scan_mul
(csrc/gl_scan.cu), one launch whatever n is; a batch inversion on a CUDA
device takes its field's segmented kernel for every array of a call
(fp252_batch_inv: two launches and one host trip; gl_batch_inv: one
launch, tile-local inverses on the device, no host trip).  prefix_mul and
batch_inv_many are the one path of every field: the scan kernels by
_native.FIELD_KERNELS, the plain versions and the batch inversion's
launch from the field's module F.KERNELS.  The affine recurrence of the
diluted aggregate (affine_scan) is one launch of fp252_affine_scan
(csrc/scan.cu) on a CUDA tensor and the Hillis-Steele stages of its
composition on the CPU.  The helpers take the field class F and work for
every field of the port (Fp252 [..., 8], GL [..., 2], GL3 [..., 6]);
affine_scan's kernel for Fp252 only, the one field of the layouts that
build the aggregate.
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
    axis 0 (from the end when reverse).  CPU tensors take the plain
    version, prefix_scan of the field's multiply; a CUDA tensor takes one
    launch of its field's running-product kernel, by the words of its
    element: Fp252's fp252_cuda.scan_launch (a memset of its look-back
    state, then the chained scan), Goldilocks' and GF(p^3)'s
    gl_cuda.scan_launch (tiles across the array's columns; the memset and
    the look-back only where a column group takes more than one tile)."""
    if a.device.type == "cpu":
        return prefix_scan(F.mul, a, reverse)
    if a.shape[-1] == 8:
        from .fp252_cuda import scan_launch
    else:
        from .gl_cuda import scan_launch
    return scan_launch(a, reverse)


def compose_maps(F):
    """The composition of affine maps x -> x a + b, fst applied first:
    (a1, b1) then (a2, b2) = (a1 a2, b1 a2 + b2), on pairs of arrays."""
    def compose(fst, snd):
        a1, b1 = fst
        a2, b2 = snd
        return F.mul(a1, a2), F.add(F.mul(b1, a2), b2)
    return compose


def affine_scan_plain(F, a, b):
    """affine_scan's plain version: prefix_scan of compose_maps over the
    pairs, then the leading one and a + b a row."""
    agg_a, agg_b = prefix_scan(compose_maps(F), (a, b))
    return torch.cat([F.ones((1,) + tuple(a.shape[1:-1]), a.device),
                      F.add(agg_a, agg_b)], dim=0)


def affine_scan(F, a, b):
    """The diluted aggregate of the recursive and starknet layouts from the
    maps x -> x a_k + b_k ([n, ..., L] each): [n + 1, ..., L], row 0 the
    start value 1 and row k + 1 the maps 0..k composed applied to it
    (a + b of the composed map).  CPU tensors take affine_scan_plain; a
    CUDA tensor one launch of fp252_affine_scan (Fp252 [n, 8] only; other
    fields and shapes raise)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return affine_scan_plain(F, a, b)
    if F.NLIMBS != 8:
        raise ValueError(f"affine_scan: no kernel for {F.NAME} (the "
                         f"layouts that build the aggregate are Fp252's)")
    from .fp252_cuda import affine_launch
    return affine_launch(a, b)


def batch_inv_many(F, arrays):
    """Montgomery batch inversion along axis 0 of each array of `arrays`
    (every column on its own; zero anywhere in a column -> that column all
    zeros, as in the JAX package) -> a list.  CPU tensors take the field's
    plain version each (F.KERNELS.batch_inv_plain); arrays on a CUDA device
    take one call of its field's kernel for all of them
    (F.KERNELS.batch_inv_cuda: Fp252's forward launch, host trip of the
    columns' totals and backward launch; Goldilocks' and GF(p^3)'s one
    launch)."""
    arrays = list(arrays)
    if all(a.device.type == "cpu" for a in arrays):
        return [F.KERNELS.batch_inv_plain(a) for a in arrays]
    out = list(arrays)   # an empty array is its own inverse
    live = [i for i, a in enumerate(arrays) if a.numel()]
    if live:
        got = F.KERNELS.batch_inv_cuda([arrays[i].contiguous()
                                        for i in live])
        for i, o in zip(live, got):
            out[i] = o
    return out


def batch_inv(F, a):
    """Montgomery batch inversion along axis 0 of one array."""
    return batch_inv_many(F, [a])[0]


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
