"""Canonical u64 host columns -> one [k, n, W] int32 tensor on a device.

The trace builders keep a column as numpy [n, 4] uint64, the canonical
value's little-endian 64-bit words; a field uploads the first W of its
eight u32 words (Fp252 all 8, Goldilocks the low 2).  upload() copies each
column's words once on the host:

- to a CUDA device, into a pinned host buffer that the process keeps and
  reuses (grown to the largest upload asked for), each column's device
  copy issued on the current stream, with no synchronize, as soon as the
  column is staged, so that its DMA overlaps the next column's host copy.
  An event recorded after the last copy guards the buffer: the next
  upload waits for it (a span h2d.<name>.wait) before writing there;
- to any other device, straight into the output tensor.

The host copies are spans h2d.<name>.stage; each column's copy issue a
span h2d.<name> that counts its bytes as h2d_bytes (on every device) and,
on the pinned route, as h2d_pinned_bytes.
"""

import threading

import numpy as np
import torch

from .. import telemetry

_LOCK = threading.Lock()
_PINNED = None      # int32 pinned host tensor, the staging buffer
_DONE = None        # event recorded after the last copy out of _PINNED


def _words(col, width: int):
    """numpy [n, 4] uint64 column -> numpy int32 [n, width] view of each
    row's first `width` u32 words (no copy)."""
    col = np.asarray(col, dtype=np.uint64)
    assert col.ndim == 2 and col.shape[1] == 4, col.shape
    return col[:, :width // 2].view(np.int32)


def _copy(dst, src):
    """One host copy of numpy `src` into CPU tensor `dst` (on torch's
    intra-op threads where torch can take src's strides as they are)."""
    if min(src.strides) >= 0 and src.flags.writeable:
        dst.copy_(torch.from_numpy(src))
    else:
        np.copyto(dst.numpy(), src)


def _staging(numel: int, name: str):
    """The pinned buffer's first `numel` int32 words, once no copy out of
    it is in flight (call with _LOCK held)."""
    global _PINNED
    if _DONE is not None:
        with telemetry.span(f"h2d.{name}.wait"):
            _DONE.synchronize()
    if _PINNED is None or _PINNED.numel() < numel:
        _PINNED = None      # the smaller block back to torch's host cache
        _PINNED = torch.empty(numel, dtype=torch.int32, pin_memory=True)
    return _PINNED[:numel]


def upload(cols, width: int, device, name: str):
    """List of numpy [n, 4] uint64 columns -> [k, n, width] int32 tensor on
    `device`: row r of output k holds the first `width` u32 words of
    cols[k][r]."""
    global _DONE
    device = torch.device(device)
    srcs = [_words(c, width) for c in cols]
    n = srcs[0].shape[0]
    assert all(s.shape[0] == n for s in srcs), [s.shape for s in srcs]
    out = torch.empty((len(srcs), n, width), dtype=torch.int32,
                      device=device)
    col_bytes = n * width * out.element_size()
    if device.type != "cuda":
        with telemetry.span(f"h2d.{name}.stage"):
            for dst, src in zip(out, srcs):
                _copy(dst, src)
        with telemetry.span(f"h2d.{name}"):
            telemetry.count("h2d_bytes", col_bytes * len(srcs))
        return out
    with _LOCK:
        stage = _staging(out.numel(), name).view(out.shape)
        try:
            for dst, host, src in zip(out, stage, srcs):
                with telemetry.span(f"h2d.{name}.stage"):
                    _copy(host, src)
                with telemetry.span(f"h2d.{name}"):
                    telemetry.count("h2d_bytes", col_bytes)
                    telemetry.count("h2d_pinned_bytes", col_bytes)
                    dst.copy_(host, non_blocking=True)
        finally:
            _DONE = torch.cuda.Event()
            _DONE.record(torch.cuda.current_stream(device))
    return out
