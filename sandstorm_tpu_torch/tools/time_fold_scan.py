"""Time the FRI fold at every layer a prove folds, and the affine pair scan,
on one CUDA card.

    python3 sandstorm_tpu_torch/tools/time_fold_scan.py [--root DIR]

Prints the card's name and power limit, then one JSON line:

- "fold": for each cell, every layer its prove folds (FriProver.num_layers
  at the default options, f = 8: starknet-eth-2^21 6 layers from 2^22 over
  Fp252, recursive-cairo-16384 5 from 2^19, plain-gl3 6 from 2^21 over
  GF(p^3), plain-cairo-gl 6 from 2^21 over Goldilocks), the launch's
  device ms, its bound (bytes: the layer read once, the table's N / 2
  multipliers, the output written once; operations: f - 1 halvings an
  output, each a product by the table and one by the stage's scalar) and
  its reach (bound / ms);
- "affine": fp252_affine_scan at 2^18 - 1 maps (starknet's and
  recursive's), the same.

A device ms is graph_ms's: the wrapper's calls (field_cuda.fold_launch,
fp252_cuda.affine_launch) captured in a CUDA graph, so that only their
device work is replayed and timed, not Python's work per call, which
takes longer than the small layers' kernels.  chip_smoke.py times its
rows with the same graph_ms.  The Fp252 running product and batch
inversion are timed by tools/time_scan.py.  `--root` imports
sandstorm_tpu_torch from another checkout of this repository (run the
script by its path), so one call can time a parent commit and a change
on the same card.  Nothing runs at import.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12    # H100 SXM's published HBM3 rate
IMAD_PER_S = 15.4e12         # the u32 multiply rate tools/probe_alu.py measures
MONTMUL_IMAD = 128           # IMAD-pipe issues of a product (chip_smoke.py)
GL_MUL_IMAD = 8
GL3_MUL_IMAD = 6 * GL_MUL_IMAD
# (cell, field words, first layer's rows, layers)
CELLS = [("starknet", 8, 1 << 22, 6), ("recursive", 8, 1 << 19, 5),
         ("gl3", 6, 1 << 21, 6), ("cairo_gl", 2, 1 << 21, 6)]
FOLD = 8


def graph_ms(torch, fn, launches=20, replays=10):
    """Mean device ms of fn()'s launches: one warm-up call, then
    `launches` calls captured in a CUDA graph, replayed `replays` times
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def with_reach(row, work):
    mem = work["bytes"] / HBM_BYTES_PER_S * 1e3
    ops = work["imad"] / IMAD_PER_S * 1e3
    b = max(mem, ops)
    return {**row, "bound_ms": b,
            "bound_by": "bytes" if mem >= ops else "operations",
            "reach": b / row["ms"]}


def measure(dev, seed=11):
    """The JSON line's fields for the sandstorm_tpu_torch on sys.path."""
    import numpy as np
    import torch
    from sandstorm_tpu_torch import _tables
    from sandstorm_tpu_torch.fields import field_cuda
    from sandstorm_tpu_torch.fields import fp252_cuda as fc
    from sandstorm_tpu_torch.fields.fp252 import Fp252
    from sandstorm_tpu_torch.fields.gl3 import GL3
    from sandstorm_tpu_torch.fields.goldilocks import GL
    from sandstorm_tpu_torch.ntt import powers_dev
    from sandstorm_tpu_torch.ntt.ntt_cuda import transform_field
    from sandstorm_tpu_torch.stark.fri import fold_scalars
    rng = np.random.default_rng(seed)
    fields = {8: Fp252, 6: GL3, 2: GL}

    def elems(F, n):
        L = F.NLIMBS
        w = rng.integers(0, 1 << 32, size=(n, L), dtype=np.uint64)
        if L == 8:
            w[:, 7] &= (1 << 27) - 1
        else:
            w[:, 1::2] %= 0xFFFFFFFF
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)

    out = {"fold": {}}
    for cell, L, N0, layers in CELLS:
        F = fields[L]
        T = transform_field(F)
        rows = []
        for k in range(layers):
            N = N0 // FOLD ** k
            M = N // FOLD
            x = elems(F, N)
            w_inv = pow(F.root_of_unity_int(N), -1, F.BASE_MODULUS)
            xinv = _tables.device_table(
                f"fri_xinv:{T.NAME}", N // 2, dev,
                lambda: powers_dev(T, w_inv, N // 2, dev))
            sc = F.encode_ints_np(fold_scalars(
                F, pow(F.GENERATOR, 3, F.BASE_MODULUS), FOLD,
                F.MODULUS // 3))
            ms = graph_ms(torch, lambda: field_cuda.fold_launch(x, xinv, sc))
            rows.append(with_reach(
                {"N": N, "M": M, "ms": ms},
                {"bytes": 4 * (N * L + N // 2 * T.NLIMBS + M * L),
                 "imad": (FOLD - 1) * M * (
                     (MONTMUL_IMAD if L == 8 else
                      GL_MUL_IMAD * (1 if L == 2 else 3))
                     + (MONTMUL_IMAD if L == 8 else
                        GL_MUL_IMAD if L == 2 else GL3_MUL_IMAD))}))
            del x
        out["fold"][cell] = rows

    n = (1 << 18) - 1
    a, b = elems(Fp252, n), elems(Fp252, n)
    ms = graph_ms(torch, lambda: fc.affine_launch(a, b))
    out["affine"] = with_reach({"n": n, "ms": ms},
                               {"bytes": 96 * n,
                                "imad": 3 * MONTMUL_IMAD * n})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_fold_scan: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    line = measure(torch.device("cuda", 0))
    print(json.dumps({"root": str(args.root), "card": smi, **line}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
