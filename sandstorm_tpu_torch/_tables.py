"""The port's one process-wide cache: constant tables on a device.

Twiddles, power tables, bit-reversal permutations and field constants are
built once per (name, size, device) and reused by every later prove on that
device.  The name carries whatever else identifies the table (base, field,
direction).
"""

import torch

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
        t = torch.as_tensor(build()).to(key[2])
        _CACHE[key] = t
    return t
