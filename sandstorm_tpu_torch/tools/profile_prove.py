"""Where the device time of one prove goes, on one CUDA card.

    python sandstorm_tpu_torch/tools/profile_prove.py [--root DIR] \\
        [--layout plain|recursive|starknet] [--scheme generic|eth|cairo] \\
        [--field fp252|goldilocks|gl3] [--proves 5] [--proof-out FILE] \\
        [--mesh D]

Proves the loop claim of one of chip_smoke.py's slices at the default
ProofOptions under `--scheme`: with --layout plain (the default) the
plain-layout claim of 2^16 steps in the 252-bit field, over Goldilocks
with --field goldilocks (give --scheme cairo for plain-cairo-gl-2^16), or
with --field gl3, Goldilocks with GF(p^3) challenges; with --layout
recursive the 16384-step recursive-layout claim of
claims.recursive_loop_claim (252-bit field; give --scheme cairo for
bench.py's configuration); with --layout starknet the 131072-step
starknet-layout claim of claims.starknet_loop_claim (2^21 rows; the scheme
defaults to the layout's, eth): one warm-up prove, then `--proves` timed
proves (host clock, each ending in a device synchronize; the trace build
and the engine timed apart), then one prove under torch.profiler.  `--root` imports sandstorm_tpu_torch from another
checkout of this repository (run the script by its path, so that the
package is not imported before the flag is read): one call can profile a
parent commit and a change on the same card.  `--mesh D` proves under a
mesh of D shards (parallel.make_mesh: D virtual shards on the one card, or
one a card where there are D or more) and reports the exchanges' device
time apart: the kernels and copies queued inside parallel/dist.py's
"mesh.exchange" ranges.

Prints the card's name and power limit, then one JSON line: the wall
times, the proof's sha256 and size (--proof-out writes its bytes), the
kernel launches of one prove by C entry, the peak device memory of the
proves after the warm-up, the prover's phases and windows of the last
timed prove, and from the profiled prove the device-busy time (the union of its
kernel, copy and set intervals), the profiled wall, and the device time
and count of each of the port's kernels and of the costliest others.
"""

import argparse
import bisect
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

STEPS = {"plain": 1 << 16, "recursive": 1 << 14, "starknet": 1 << 17}
# the port's C kernels, by a piece of their (demangled) device name
SHORT = [("walk_kernel", "ec_madd_walk"),
         ("gl_ntt_leaf_kernel<4, true", "gl_ntt_leaf_fused"),
         ("gl_ntt_leaf_kernel", "gl_ntt_leaf"),
         ("ntt_leaf_kernel<3, true", "ntt_leaf_fused"),
         ("ntt_leaf_kernel", "ntt_leaf"), ("::binop_kernel<2>", "fp252_mul"),
         ("::binop_kernel<0>", "fp252_add"), ("::binop_kernel<1>", "fp252_sub"),
         ("gl_binop_kernel<2>", "gl_mul"), ("gl_binop_kernel<0>", "gl_add"),
         ("gl_binop_kernel<1>", "gl_sub"), ("gl3_mul_kernel", "gl3_mul"),
         ("open_pairs_kernel", "open_pairs"),
         # an earlier checkout's two-launch opener (--root)
         ("open_pairs_partial", "open_pairs_partial"),
         ("open_pairs_reduce", "open_pairs_reduce"),
         ("blake2s_kernel", "blake2s_rows"),
         ("keccak_kernel", "keccak_rows"), ("grind_kernel", "pow_grind"),
         # the scan, the batch inversion's two launches, DEEP, and the
         # generated group kernels (g0, g1, ... taking the Tabs struct of
         # air/codegen.py); an earlier checkout's scan in three passes
         ("scan_kernel", "fp252_scan_mul"),
         ("inv_forward_kernel", "fp252_batch_inv"),
         ("inv_backward_kernel", "fp252_batch_inv"),
         ("totals_kernel", "fp252_scan_mul"), ("carry_kernel", "fp252_scan_mul"),
         ("apply_kernel", "fp252_scan_mul"), ("deep_kernel", "deep_compose"),
         ("::Tabs", "air_group")]


def _short(name):
    return next((short for key, short in SHORT if key in name), name[:80])


def _busy_ms(events):
    """Length of the union of the device intervals, ms."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, end = 0.0, None
    start = None
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total / 1e3


def _annotated(events, device, name):
    """The device events (of `device`) queued from inside the CPU ranges
    called `name`: the runtime calls that start inside a range give the
    correlation ids of their kernels and copies."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("name") == name
                    and e.get("cat") == "user_annotation")
    starts = [a for a, _ in ranges]
    corr = set()
    for e in events:
        if e.get("cat") != "cuda_runtime" or e.get("ph") != "X":
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and e["ts"] <= ranges[i][1]:
            corr.add(e.get("args", {}).get("correlation"))
    corr.discard(None)
    return [e for e in device
            if e.get("args", {}).get("correlation") in corr]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--layout", default="plain",
                    choices=["plain", "recursive", "starknet"])
    ap.add_argument("--scheme", default=None,
                    help="generic, eth or cairo (default: eth for "
                         "starknet, else generic)")
    ap.add_argument("--field", default="fp252",
                    choices=["fp252", "goldilocks", "gl3"])
    ap.add_argument("--proves", type=int, default=5)
    ap.add_argument("--proof-out", type=Path)
    ap.add_argument("--mesh", type=int, default=0,
                    help="prove under a mesh of this many shards")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    from sandstorm_tpu_torch import _native
    from sandstorm_tpu_torch import claims
    from sandstorm_tpu_torch.fields.fp252 import Fp252
    from sandstorm_tpu_torch.fields.gl3 import GL3
    from sandstorm_tpu_torch.fields.goldilocks import GL
    from sandstorm_tpu_torch.stark import prover
    from sandstorm_tpu_torch.stark.ark import serialize_proof
    from sandstorm_tpu_torch.stark.options import ProofOptions

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    steps = STEPS[args.layout]
    if args.scheme is None:
        args.scheme = "eth" if args.layout == "starknet" else "generic"
    if args.layout != "plain" and args.field != "fp252":
        ap.error(f"the {args.layout} layout takes the 252-bit field only")
    if args.layout == "recursive":
        claim, witness = claims.recursive_loop_claim(steps, dev,
                                                     scheme=args.scheme)
    elif args.layout == "starknet":
        claim, witness = claims.starknet_loop_claim(steps, dev,
                                                    scheme=args.scheme)
    else:
        claim, witness = claims.loop_claim(
            steps, dev, scheme=args.scheme,
            field={"fp252": Fp252, "goldilocks": GL, "gl3": GL3}[args.field])
    options = ProofOptions()
    mesh = None
    if args.mesh:
        from sandstorm_tpu_torch.parallel import dist, make_mesh
        mesh = make_mesh(args.mesh) if torch.cuda.device_count() >= \
            args.mesh > 1 else make_mesh(args.mesh, device=dev)

    def one_prove():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace = claim.generate_trace(witness)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        proof = prover.prove(claim.F, claim.air_config, trace, options,
                             scheme=claim.scheme,
                             **({"mesh": mesh} if mesh else {}))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return proof, t1 - t0, t2 - t1

    proof, _, _ = one_prove()                       # warm-up: tables built
    blob = serialize_proof(proof)
    if args.proof_out:
        args.proof_out.write_bytes(blob)
    torch.cuda.reset_peak_memory_stats(dev)
    walls, traces, engines = [], [], []
    for i in range(args.proves):
        if i == 0:
            _native.reset_counts()
            ntt_calls = dist.NTT_CALLS if mesh else 0
        _, tr, en = one_prove()
        if i == 0:
            launches = dict(_native.LAUNCHES)
            ntt_calls = (dist.NTT_CALLS - ntt_calls) if mesh else 0
        walls.append(tr + en)
        traces.append(tr)
        engines.append(en)
    phases = [[k, v] for k, v in prover.LAST_PHASES]
    windows = dict(prover.LAST_CHUNKS)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_prove()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace_path))
        events = json.loads(trace_path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = {}
    for e in device:
        name = _short(e["name"]) if e["cat"] == "kernel" else e["cat"]
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e["dur"] / 1e3, n + 1)
    # every kernel of the port, and the costliest of the rest
    ours = {short for _, short in SHORT}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    mesh_line = {}
    if mesh:
        exchange = _annotated(events, device, "mesh.exchange")
        mesh_line = {"mesh": {"shards": mesh.size,
                              "devices": [str(d) for d in mesh.devices],
                              "dist_ntt_calls": ntt_calls,
                              "exchange_device_ms": _busy_ms(exchange),
                              "exchange_events": len(exchange)}}
    top = [kv for kv in ranked if kv[0] in ours] + \
        [kv for kv in ranked if kv[0] not in ours][:10]
    print(json.dumps({
        "cell": (f"{args.layout}-{args.scheme}-{steps}"
                 if args.layout != "plain"
                 else f"plain-{args.scheme}-2^16" if args.field == "fp252"
                 else f"plain-{args.scheme}-gl-2^16"
                 if args.field == "goldilocks"
                 else "plain-gl3-2^16")
                + (f"-mesh{args.mesh}" if mesh else ""),
        "root": str(args.root),
        "nvidia_smi": smi, "prove_s": walls,
        "prove_s_median": statistics.median(walls),
        "trace_build_s_median": statistics.median(traces),
        "engine_s_median": statistics.median(engines),
        "proof_sha256": hashlib.sha256(blob).hexdigest(),
        "proof_bytes": len(blob), "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "phases": phases, "windows": windows,
        "profiled_wall_ms": wall_ms, "device_busy_ms": _busy_ms(device),
        "device_busy_share": _busy_ms(device) / wall_ms,
        "device_ms_by_kernel": {k: [ms, n] for k, (ms, n) in top},
        **mesh_line}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
