"""Time gl_scan_mul, the Goldilocks and GF(p^3) running product, on one
CUDA card.

    python3 sandstorm_tpu_torch/tools/time_gl_scan.py [--root DIR] \\
        [--check] [--sweep]

Prints the card's name and power limit, then one JSON line.  For each
field (GL, GF(p^3)) and shape, [n, C] elements: [2^21, 1] (chip_smoke's
row), and a plain-layout prove's three, [2^19, 1] and [2^18, 1] (the
permutation column's memory and range-check running products) and [1024,
20] (the opener's power tables, one column a DEEP point): the
milliseconds of one forward `prefix_mul` (CUDA events over back-to-back
calls on one input, so warm in L2 where it fits; at small shapes the
host's dispatch sets this pace), its device operations (the kernels and
memsets of one call in a torch.profiler trace) and their device
microseconds a call, its byte bound (each element read once and written
once at 3.35 TB/s) and reach (bound / ms, and bound / device time), and
where the package has it, the call's tile (rows a thread m, columns a
tile cw, rows a tile R, tiles).  `--check` holds
every shape, both directions, to `prefix_scan` of the plain multiply, bit
for bit.  `--sweep` gives the device microseconds of
the same shapes at every other tile the kernel takes (m rows a thread, cw
columns a tile), each checked against the default's output.  `--root` imports sandstorm_tpu_torch from another
checkout of this repository (run the script by its path): one call can
time a parent commit and a change on the same card.  Nothing runs at
import.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
SHAPES = [(1 << 21, 1), (1 << 19, 1), (1 << 18, 1), (1024, 20)]
ITERS = 20


def event_ms(torch, fn, iters=ITERS):
    """Mean milliseconds of fn() over `iters` back-to-back calls, CUDA
    events, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ops(torch, fn, calls=5):
    """(the names of one call's device operations, kernels and memsets;
    their summed device microseconds a call, the mean over `calls`
    calls) from a torch.profiler trace of fn."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return ([e.name for e in ops[:len(ops) // calls]],
            sum(e.time_range.elapsed_us() for e in ops) / calls)


def rand_elems(torch, np, rng, n, L, dev):
    """n random canonical elements of L words (GL: 2, GF(p^3): 6)."""
    w = rng.integers(0, 1 << 32, size=(n, L), dtype=np.uint64)
    w[:, 1::2] %= 0xFFFFFFFF          # each hi word < 2^32 - 1: below p
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


def alternatives(C):
    """Every (m, cw) the kernel takes for a call of C columns: m rows a
    thread, cw columns a tile (no wider than twice C)."""
    return [(1 << lm, 1 << lcw) for lcw in range(6)
            if lcw == 0 or 1 << lcw < 2 * C for lm in range(6)]


def launch_tile(torch, x, reverse, m, cw):
    """gl_scan_mul of an [n, C, L] CUDA tensor on a tile of m rows a thread
    and cw columns (not scan_tiles' own), straight through the C entry."""
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch.fields import gl_cuda
    n, C, L = x.shape
    R = m * gl_cuda.SCAN_THREADS // cw
    tiles = -(-n // R) * -(-C // cw)
    out = torch.empty_like(x)
    status = torch.empty(gl_cuda.scan_status_words(tiles, cw, L),
                         dtype=torch.int32, device=x.device)
    _native.launch("gl_scan_mul", x.device, x.data_ptr(), n, C,
                   int(reverse), m.bit_length() - 1, cw.bit_length() - 1, L,
                   out.data_ptr(), status.data_ptr())
    return out


def measure(dev, check, sweep, seed=18):
    """The JSON line's fields for the sandstorm_tpu_torch on sys.path."""
    import numpy as np
    import torch
    from sandstorm_tpu_torch.fields import gl_cuda
    from sandstorm_tpu_torch.fields.gl3 import GL3
    from sandstorm_tpu_torch.fields.goldilocks import GL
    from sandstorm_tpu_torch.fields.scan import prefix_mul, prefix_scan
    rng = np.random.default_rng(seed)
    out = {}
    for F in (GL, GL3):
        L = F.NLIMBS
        mul = gl_cuda.plain_ops(L)[2]
        rows = {}
        for n, C in SHAPES:
            x = rand_elems(torch, np, rng, n * C, L, dev).reshape(n, C, L)
            x[n // 3, C - 1] = 0
            got = prefix_mul(F, x)
            ops, us = device_ops(torch, lambda: prefix_mul(F, x))
            row = {"ms": event_ms(torch, lambda: prefix_mul(F, x)),
                   "device_ops": ops, "device_us": us,
                   "bound_ms": 2 * 4 * L * n * C / HBM_BYTES_PER_S * 1e3}
            row["reach"] = row["bound_ms"] / row["ms"]
            row["device_reach"] = row["bound_ms"] * 1e3 / us
            if hasattr(gl_cuda, "scan_tiles"):
                m, cw, R, per_group, groups = gl_cuda.scan_tiles(n, C, L)
                row.update(m=m, cw=cw, R=R, tiles=per_group * groups)
            if check:
                row["bit_exact"] = all(
                    torch.equal(prefix_mul(F, x, rev),
                                prefix_scan(mul, x, rev))
                    for rev in (False, True))
            if sweep:
                alt = {}
                for m, cw in alternatives(C):
                    if (m, cw) == (row["m"], row["cw"]):
                        continue
                    ok = torch.equal(launch_tile(torch, x, False, m, cw),
                                     got) and torch.equal(
                        launch_tile(torch, x, True, m, cw),
                        prefix_mul(F, x, True))
                    alt[f"m{m}_cw{cw}"] = [device_ops(
                        torch, lambda: launch_tile(torch, x, False, m,
                                                   cw))[1], ok]
                row["sweep"] = alt
            rows[f"{n}x{C}"] = row
            del x, got
        out[F.NAME] = rows
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_gl_scan: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    line = measure(torch.device("cuda", 0), args.check, args.sweep)
    print(json.dumps({"root": str(args.root), **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
