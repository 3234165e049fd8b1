"""The port's one process-wide cache: constant tables on a device.

Twiddles, power tables, bit-reversal permutations and field constants are
built once per (name, size, device) and reused by every later prove on that
device.  The name carries whatever else identifies the table (base, field,
direction).
"""

import torch

from . import telemetry

_CACHE = {}


def _norm(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_table(name: str, size: int, device, build):
    """The cached tensor for (name, size, device); `build()` returns a numpy
    array or a tensor (on any device) the first time it is asked for."""
    key = (name, size, _norm(device))
    t = _CACHE.get(key)
    if t is None:
        t = build()
        if not (torch.is_tensor(t) and t.device == key[2]):
            t = telemetry.to_device(t, key[2], "table")
        _CACHE[key] = t
    return t


def evict(name: str, device):
    """Drop every cached size of table `name` on `device`, so that its next
    use builds it again (and its memory is freed once no caller holds it)."""
    device = _norm(device)
    for key in [k for k in _CACHE if k[0] == name and k[2] == device]:
        del _CACHE[key]
