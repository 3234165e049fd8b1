"""Measure the GPU's ALU rates: R = 256 chained u32 multiply, add,
multiply-add and shift-and operations against f32 multiply and FMA per
element, in registers (csrc/probe_alu.cu; port of tools/probe_alu.py,
which asked the TPU's vector unit the same question: could a float-based
digit multiply beat the integer montmul?).

    python -m sandstorm_tpu_torch.tools.probe_alu    # one CUDA card

prints one line per op with its milliseconds and Tops/s (one op is one
chained expression, o = op(o, b), per element), after the card's name and
power limit.  `probe_alu(a, b, op)` runs the kernel on CUDA tensors and its
plain twin, `probe_alu_plain`, on CPU tensors.
"""

import subprocess
import sys
import time

import numpy as np
import torch

from .. import _native

R = 256                       # chained ops per element, as on the TPU
TILE = 256 * 128              # elements of a and b (the TPU's VMEM block)
COPIES = 8192                 # copies of the tile in the grid (the TPU grid)
OPS = ["u32 mul", "u32 add", "u32 mul+add", "u32 shift+and", "f32 mul",
       "f32 fma"]
# relative tolerance of the f32 ops against the plain twin: the kernel's
# fma rounds once per step and torch's o * b + o twice, over 256 steps
F32_RTOL = 1e-4

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF


def _u32_mul(o, b):
    """o * b mod 2^32 on int64 carriers (a 32 x 32 product overflows
    int64, so b goes in as two 16-bit halves)."""
    lo = o * (b & _M16)
    hi = (o * (b >> 16)) & _M16
    return (lo + (hi << 16)) & _M32


def probe_alu_plain(a, b, op: str, reps: int = R):
    """The chain o = op(o, b), `reps` times, from o = a: u32 ops on [n]
    int32 tensors holding u32 bits (computed in int64 carriers with
    masking, since int32 >> is arithmetic), f32 ops on [n] float32."""
    if op.startswith("f32"):
        o = a.clone()
        for _ in range(reps):
            o = o * b if op == "f32 mul" else o * b + o
        return o
    o = a.to(torch.int64) & _M32
    y = b.to(torch.int64) & _M32
    for _ in range(reps):
        if op == "u32 mul":
            o = _u32_mul(o, y)
        elif op == "u32 add":
            o = (o + y) & _M32
        elif op == "u32 mul+add":
            o = (_u32_mul(o, y) + o) & _M32
        else:
            o = (o >> 7) & y
    return (o - ((o >> 31) << 32)).to(torch.int32)


def probe_alu(a, b, op: str, copies: int = COPIES):
    """One launch of the probe kernel over `copies` copies of the [tile]
    inputs (every copy computes the same chain: the grid only fills the
    card); returns the [tile] results.  CPU tensors take the plain twin."""
    if op not in OPS:
        raise ValueError(f"probe_alu: unknown op {op!r}")
    dtype = torch.float32 if op.startswith("f32") else torch.int32
    if a.shape != b.shape or a.dim() != 1 or a.dtype != dtype \
            or b.dtype != dtype:
        raise ValueError(f"probe_alu: inputs {tuple(a.shape)} {a.dtype}, "
                         f"{tuple(b.shape)} {b.dtype} for {op!r}")
    if a.device.type == "cpu":
        return probe_alu_plain(a, b, op)
    out = torch.empty_like(a)
    for name, t in (("a", a), ("b", b), ("out", out)):
        _native.check_cuda_tensor(t, f"probe_alu {name}", dtype=dtype)
    _native.launch("probe_alu", a.device, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), OPS.index(op), a.numel(),
                   a.numel() * copies)
    return out


def inputs(op: str, device, n: int = TILE, seed: int = 0):
    """(a, b) for `op` from a numpy seed: u32 words anywhere; f32 values
    that keep 256 steps finite and normal (b near 1 for mul, near 0 for
    fma, whose step is o (1 + b))."""
    rng = np.random.default_rng(seed)
    if op.startswith("f32"):
        a = rng.uniform(0.5, 2.0, n).astype(np.float32)
        b = (rng.uniform(0.998, 1.002, n) if op == "f32 mul"
             else rng.uniform(-0.002, 0.002, n)).astype(np.float32)
        return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    a, b = (rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            .view(np.int32) for _ in range(2))
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def run(op: str, device, iters: int = 3):
    """(ms of one launch, Tops/s) of `op` on a CUDA device: the best of
    `iters` timed launches after a warm-up, by CUDA events."""
    a, b = inputs(op, device)
    probe_alu(a, b, op)
    best = float("inf")
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        probe_alu(a, b, op)
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end))
    return best, TILE * COPIES * R / (best * 1e-3) / 1e12


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_alu: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for op in OPS:
        ms, tops = run(op, dev)
        print(f"{op:16s} {ms:8.3f} ms   {tops:7.2f} Tops/s", flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
