"""Running products of field arrays.

A Hillis-Steele inclusive scan: log2(n) stages, stage s multiplying every
row k >= 2^s by row k - 2^s, each stage one elementwise multiply (the
montmul kernel on a CUDA tensor).  n log n multiplies instead of the 2n of
a work-efficient scan, but every stage is one full-width launch.
"""

import torch


def prefix_mul(F, a, reverse: bool = False):
    """Inclusive running product of an [n, ..., 8] field array along
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
