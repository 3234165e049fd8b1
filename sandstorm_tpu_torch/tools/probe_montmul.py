"""The Fp252 montmul's two product forms on one CUDA card.

    python -m sandstorm_tpu_torch.tools.probe_montmul

csrc/fp252.cuh has two schoolbook products: `fp::mul` (rows: a
product's lo and hi words on two carry chains), which most kernels use,
and `fp::mul_wide_redc` (aligned pairs: one IMAD.WIDE.U32.X a product),
which deep.cu and the generated constraint-group kernels use.  This tool
builds one kernel a form, each thread chaining ITERS montmuls of its own
pair over THREADS threads, checks that the two forms give the same bits
(and one product against the plain version on the CPU), and prints the
card's name and power limit, then one JSON line: per form, the SASS
instruction counts of its kernel by opcode (cuobjdump -sass), their total,
and the rate in G montmuls/s (CUDA events, best of RUNS).  Nothing is
built at import.
"""

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ITERS = 64
THREADS = 1 << 21
RUNS = 3
FORMS = {"mul": 0, "mul_wide_redc": 1}

SOURCE = r"""
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

template <int V>
__global__ void __launch_bounds__(128)
chain(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
      uint32_t* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (i >= n) return;
  fp::F x = fp::load(a + i * 8);
  const fp::F y = fp::load(b + i * 8);
#pragma unroll 1
  for (int it = 0; it < iters; it++)
    x = V ? fp::mul_wide_redc(x, y) : fp::mul(x, y);
  fp::store(out + i * 8, x);
}

}  // namespace

extern "C" int montmul_chain(const void* a, const void* b, void* out, int n,
                             int iters, int form, void* stream) {
  const unsigned blocks = (unsigned)((n + 127) / 128);
  if (form)
    chain<1><<<blocks, 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, iters);
  else
    chain<0><<<blocks, 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, iters);
  return (int)cudaGetLastError();
}
"""


def sass_counts(path: str) -> dict:
    """{template argument: Counter of SASS opcodes} of the library's two
    chain kernels."""
    from .. import _native
    cuobjdump = Path(_native.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", path],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*chainILi(\d)E", line)
        if m:
            cur = int(m.group(1))
            counts[cur] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            counts[cur][m.group(1)] += 1
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_montmul: no CUDA device", file=sys.stderr)
        return 1
    from .. import _native
    from ..fields import fp252_cuda
    from ..fields.fp252 import Fp252
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    path = _native.build_generated(
        {"probe_montmul": [SOURCE]})["probe_montmul"]["path"]
    fn = ctypes.CDLL(path).montmul_chain
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(10)
    words = torch.randint(0, 1 << 32, (2, THREADS, 8), dtype=torch.int64,
                          device=dev, generator=gen)
    words[..., 7] &= (1 << 27) - 1
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    a, b = words.to(torch.int32).unbind(0)
    a[0] = b[0] = Fp252.encode_ints([Fp252.MODULUS - 1], dev)[0]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(form, iters):
        out = torch.empty_like(a)
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), THREADS, iters,
                form, stream)
        if rc:
            raise RuntimeError(f"montmul_chain: CUDA error {rc}")
        return out

    one = {f: run(v, 1) for f, v in FORMS.items()}
    plain = fp252_cuda.mul_plain(a[:4096].cpu(), b[:4096].cpu())
    chained = {f: run(v, ITERS) for f, v in FORMS.items()}
    equal = (torch.equal(one["mul"], one["mul_wide_redc"])
             and torch.equal(one["mul"][:4096].cpu(), plain)
             and torch.equal(chained["mul"], chained["mul_wide_redc"]))
    counts = sass_counts(path)
    forms = {}
    for f, v in FORMS.items():
        best = None
        for _ in range(RUNS):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            run(v, ITERS)
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1)
            best = ms if best is None else min(best, ms)
        forms[f] = {"ms": best,
                    "g_montmuls_per_s": THREADS * ITERS / best / 1e6,
                    "sass_total": sum(counts[v].values()),
                    "sass": dict(counts[v].most_common(16))}
    print(json.dumps({"threads": THREADS, "iters": ITERS,
                      "bit_equal": equal, "forms": forms}), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
