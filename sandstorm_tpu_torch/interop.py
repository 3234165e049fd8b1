"""Conversions between the JAX package's field arrays and the port's.

The JAX package stores an Fp252 element as [..., 16] u32 16-bit digits of
its Montgomery form; the port stores the same Montgomery integer as
[..., 8] int32 limbs, limb k = d[2k] | d[2k+1] << 16.  Only the tests use
these: they hand both packages the same data.
"""

import numpy as np
import torch


def from_jax_digits(digits) -> torch.Tensor:
    """numpy [..., 16] digits -> int32 [..., 8] Montgomery limbs (CPU)."""
    d = np.asarray(digits, dtype=np.uint32)
    words = d[..., 0::2] | (d[..., 1::2] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32).copy())


def to_jax_digits(limbs: torch.Tensor) -> np.ndarray:
    """int32 [..., 8] limbs (any device) -> numpy uint32 [..., 16] digits."""
    w = limbs.cpu().numpy().view(np.uint32)
    d = np.stack([w & np.uint32(0xFFFF), w >> np.uint32(16)], axis=-1)
    return d.reshape(w.shape[:-1] + (16,))


def columns_from_jax(cols):
    """dict col -> JAX [n, 16] LDE or coefficient column (numpy or jax
    array) -> dict col -> port [n, 8] tensor."""
    return {k: from_jax_digits(np.asarray(v)) for k, v in cols.items()}
