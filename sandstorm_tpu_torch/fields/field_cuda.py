"""The launches of the kernels that serve every field, chosen by the words
of the element through _native.FIELD_KERNELS: the FRI fold (csrc/fri.cu,
fold_launch: fp252_fri_fold, gl_fri_fold) and the coset scale and pad
(csrc/scale_pad.cu, scale_pad_launch: fp252_scale_pad, gl_scale_pad).

Their plain versions live beside their callers (stark/fri.py
fri_fold_plain, ntt/ntt.py scale_pad_plain); these wrappers take CUDA
tensors only and raise on anything else.  Importing this module builds
and loads nothing.
"""

import numpy as np
import torch

from .. import _native

FOLD_MAX_STAGES = 4     # MAX_STAGES in csrc/fri.cu: a fold by f up to 16
FOLD_LANE_THREADS = 128  # LANE_THREADS in csrc/fri.cu: a small layer's an SM


def fold_lanes(M: int, f: int, sms: int) -> int:
    """log2 of the lanes an output the fold kernel takes for M outputs of a
    fold by f on a card of `sms` SMs, as csrc/fri.cu's fold_lanes picks it
    (the entry decides; this mirror serves the tests and the timing
    rows).  A wide layer (M above FOLD_LANE_THREADS an SM) takes a thread
    an output; a small one the most lanes, up to f / 2, that keep its M x
    lanes threads within FOLD_LANE_THREADS an SM: its launch is
    latency-bound, and the lanes shorten a thread's chain of halvings."""
    cap = FOLD_LANE_THREADS * sms
    lg = 0
    if M <= cap:
        while lg + 1 < f.bit_length() - 1 and M << (lg + 1) <= cap:
            lg += 1
    return lg


def fold_launch(evals, xinv, scalars):
    """One launch of the FRI fold kernel of a CUDA [N, L] layer's field
    (_native.FIELD_KERNELS[L]["fold"]: fp252_fri_fold, gl_fri_fold), every
    halving in it: the [N / 2^S, L] folded layer.  xinv: the table w^-i,
    i < N / 2, on the layer's device, its rows' first words the multiplier
    (an Fp252 element; over GF(p^3) Goldilocks' own table, [N / 2, 2]);
    scalars: numpy int32 [S, L], stage s's c^(-2^s) beta^(2^s) in the
    field's words, passed by value.  The kernel picks its form from the
    layer (fold_lanes).  Raises on what the kernel does not take."""
    L = evals.shape[-1]
    k = _native.FIELD_KERNELS[L]
    entry, align = k["fold"], k["align"]
    sc = np.ascontiguousarray(scalars, dtype=np.int32)
    S = sc.shape[0]
    N = evals.shape[0]
    if not 1 <= S <= FOLD_MAX_STAGES or sc.shape != (S, L):
        raise ValueError(f"{entry}: {S} stages of scalars {sc.shape} (1 to "
                         f"{FOLD_MAX_STAGES} of {L} words)")
    if evals.dim() != 2 or N % (1 << S) or xinv.dim() != 2 \
            or xinv.shape[0] < N // 2 or xinv.device != evals.device:
        raise ValueError(f"{entry}: a layer {tuple(evals.shape)} and a "
                         f"table {tuple(xinv.shape)} on {xinv.device}")
    evals = evals.contiguous()
    out = torch.empty((N >> S, L), dtype=torch.int32, device=evals.device)
    for name, t in (("evals", evals), ("out", out)):
        _native.check_cuda_tensor(t, f"{entry} {name}", last_dim=L,
                                  align=align)
    _native.check_cuda_tensor(xinv, f"{entry} xinv", align=align)
    _native.launch(entry, evals.device, evals.data_ptr(), xinv.data_ptr(),
                   xinv.shape[1], sc.ctypes.data, S, N >> S, *k["args"],
                   out.data_ptr())
    return out


def _strided(x, align: int):
    """An [n, C, L] view of x (or a copy) whose row and column strides
    keep the kernel's `align`-byte loads aligned, and its strides in
    words (the column stride 0 for one column)."""
    n, L = x.shape[0], x.shape[-1]
    v = x.reshape(n, -1, L)
    C = v.shape[1]
    rs, cs = v.stride(0), (v.stride(1) if C > 1 else 0)
    if v.stride(2) != 1 or v.data_ptr() % align or (rs * 4) % align \
            or (cs * 4) % align:
        v = v.contiguous()
        rs, cs = v.stride(0), (v.stride(1) if C > 1 else 0)
    return v, rs, cs


def scale_pad_launch(x, N: int, table=None, factor=None):
    """One launch of the coset scale and pad kernel of a CUDA [n, ..., L]
    array's field (_native.FIELD_KERNELS[L]["scale"]: fp252_scale_pad,
    gl_scale_pad): a new contiguous [N, ..., L] array whose row i < n is
    x's row i times table row i (the coset powers: an [>= n, Lt] tensor on
    x's device, its rows' first words the multiplier) or times `factor`
    (numpy int32 words of one multiplier, passed by value), and whose rows
    n .. N - 1 are zero.  x may be a view (its strides are passed).  Over
    GF(p^3) the multiplier is a Goldilocks value.  Raises on what the
    kernel does not take."""
    L = x.shape[-1]
    k = _native.FIELD_KERNELS[L]
    entry, align = k["scale"], k["align"]
    n = x.shape[0]
    if N < n or (table is None) == (factor is None):
        raise ValueError(f"{entry}: {n} rows padded to {N}, one of a table "
                         f"or a factor")
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: expected a CUDA tensor, got {x.device}")
    v, rs, cs = _strided(x, align)
    out = torch.empty((N,) + tuple(x.shape[1:]), dtype=torch.int32,
                      device=x.device)
    _native.check_cuda_tensor(out, f"{entry} out", last_dim=L, align=align)
    if x.dtype != torch.int32:
        raise ValueError(f"{entry}: expected torch.int32, got {x.dtype}")
    fac = None
    if table is not None:
        if table.dim() != 2 or table.shape[0] < n \
                or table.device != x.device or table.stride(1) != 1 \
                or table.data_ptr() % align or (table.stride(0) * 4) % align \
                or table.dtype != torch.int32:
            raise ValueError(f"{entry}: a table {tuple(table.shape)} "
                             f"{table.dtype} on {table.device} for {n} rows")
        tptr, ts = table.data_ptr(), table.stride(0)
    else:
        fac = np.ascontiguousarray(factor, dtype=np.int32)
        tptr, ts = None, 0
    _native.launch(entry, x.device, v.data_ptr(), rs, cs, n, v.shape[1],
                   tptr, ts, None if fac is None else fac.ctypes.data, N,
                   *k["args"], out.data_ptr())
    return out
