"""Time the Fp252 running product and batch inversion on one CUDA card.

    python sandstorm_tpu_torch/tools/time_scan.py [--root DIR]

Prints the card's name and power limit, then one JSON line: the
microseconds of one `Fp252.batch_inv` call at n = 1, 2^6, 2^10, 2^14, 2^18
and 2^22 rows (host clock around the call and a synchronize, the median of
REPEATS calls after a warm-up), the milliseconds of one `prefix_mul` and one
`Fp252.batch_inv` at 2^21 and 2^22 rows (CUDA events over back-to-back
calls) and of the batch inversion's two launches alone (its host trip made
once), and, where the package has them, the host trip of the batch
inversion alone (`fp252_cuda.invert_totals` of 1 and of 25 totals on the
card) and `batch_inv_many` of 25 arrays of 2^14 rows against 25 calls of
`Fp252.batch_inv`.  `--root` imports sandstorm_tpu_torch from another
checkout of this repository (run the script by its path): one call can
time a parent commit and a change on the same card.  Nothing runs at
import.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SMALL = [0, 6, 10, 14, 18, 22]   # log2 n of the latency line
REPEATS = 21


def host_us(torch, fn, repeats=REPEATS):
    """Median microseconds of fn() and a synchronize, host clock, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def event_ms(torch, fn, iters=10):
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


def rand_elems(torch, np, rng, n, dev):
    """n random canonical Fp252 elements (Montgomery words) on dev."""
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    w[:, 7] &= (1 << 27) - 1
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


def measure(dev, seed=11):
    """The JSON line's fields for the sandstorm_tpu_torch on sys.path."""
    import numpy as np
    import torch
    from sandstorm_tpu_torch.fields import fp252_cuda as fc
    from sandstorm_tpu_torch.fields import scan
    from sandstorm_tpu_torch.fields.fp252 import Fp252 as F
    rng = np.random.default_rng(seed)
    out = {"batch_inv_us": {}, "ms": {}}
    for logn in SMALL:
        x = rand_elems(torch, np, rng, 1 << logn, dev)
        out["batch_inv_us"][f"2^{logn}"] = host_us(
            torch, lambda: F.batch_inv(x), 5 if logn >= 18 else REPEATS)
    for logn in (21, 22):
        x = rand_elems(torch, np, rng, 1 << logn, dev)
        out["ms"][f"scan_mul_2^{logn}"] = event_ms(
            torch, lambda: scan.prefix_mul(F, x))
        out["ms"][f"batch_inv_2^{logn}"] = event_ms(
            torch, lambda: F.batch_inv(x))
        if hasattr(fc, "inv_launch"):
            # the batch inversion's two launches alone, the host trip's
            # seeds computed once
            job = fc.inv_prepare([x])
            fc.inv_launch(job, 0, job["totals"])
            seeds = fc.invert_totals(job["totals"])
            out["ms"][f"batch_inv_launches_2^{logn}"] = event_ms(
                torch, lambda: (fc.inv_launch(job, 0, job["totals"]),
                                fc.inv_launch(job, 1, seeds)))
            del job, seeds
        del x
    if hasattr(fc, "invert_totals"):
        for m in (1, 25):
            t = rand_elems(torch, np, rng, m, dev)
            out[f"host_trip_us_{m}"] = host_us(
                torch, lambda: fc.invert_totals(t))
    if hasattr(scan, "batch_inv_many"):
        xs = [rand_elems(torch, np, rng, 1 << 14, dev) for _ in range(25)]
        out["batch_inv_many_25x2^14_us"] = host_us(
            torch, lambda: scan.batch_inv_many(F, xs))
        out["batch_inv_25_calls_2^14_us"] = host_us(
            torch, lambda: [F.batch_inv(x) for x in xs])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_scan: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    line = measure(torch.device("cuda", 0))
    print(json.dumps({"root": str(args.root), **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
