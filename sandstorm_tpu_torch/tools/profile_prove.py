"""Where the device time of one prove goes, on one CUDA card.

    python sandstorm_tpu_torch/tools/profile_prove.py [--root DIR] \\
        [--layout plain|recursive|starknet] [--scheme generic|eth|cairo] \\
        [--field fp252|goldilocks|gl3] [--proves 5] [--proof-out FILE] \\
        [--mesh D] [--steps N] [--options Q,B,W,F,R] [--profiled K]

Proves the loop claim of one of chip_smoke.py's slices at the default
ProofOptions under `--scheme`: with --layout plain (the default) the
plain-layout claim of 2^16 steps in the 252-bit field, over Goldilocks
with --field goldilocks (give --scheme cairo for plain-cairo-gl-2^16), or
with --field gl3, Goldilocks with GF(p^3) challenges; with --layout
recursive the 16384-step recursive-layout claim of
claims.recursive_loop_claim (252-bit field; give --scheme cairo for
bench.py's configuration); with --layout starknet the 131072-step
starknet-layout claim of claims.starknet_loop_claim (2^21 rows; the scheme
defaults to the layout's, eth), or of `--steps` steps; the proof options
are ProofOptions()'s, or `--options` (queries, blowup, grinding bits,
folding factor, remainder coefficients; the benchmark's recursive-cairo
cells: --steps 131072 --options 18,16,24,8,16 for b16, 65,2,16,8,16 for
b2): one warm-up prove, then `--proves` timed
proves (host clock, each ending in a device synchronize; the trace build
and the engine timed apart), then `--profiled` proves under
torch.profiler.  `--root` imports sandstorm_tpu_torch from another
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

The recorder's spans (sandstorm_tpu_torch.telemetry) are the profiled
proves' record_function ranges, so the line also places the device's work
and its idle time by program span: "by_span" gives, for the innermost span
path (its last three names), the device ms of the kernels and copies
queued inside it and the device-idle ms spent inside it; "idle_gaps" the
ten longest idle gaps, each named by the span path that covers most of
it; "idle_unattributed" the idle share outside every span or in the self
time of "prove" or of a phase span (the idle time no span explains).
"recorder" gives a prove's span records and counter increments
and the host cost of one span with no profiler (ns, and its share of the
timed prove).
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
         ("gl_open_pairs_kernel<GL", "gl_open_pairs"),
         ("open_pairs_kernel", "open_pairs"),
         # an earlier checkout's two-launch opener (--root)
         ("open_pairs_partial", "open_pairs_partial"),
         ("open_pairs_reduce", "open_pairs_reduce"),
         ("blake2s_kernel", "blake2s_rows"),
         ("keccak_kernel", "keccak_rows"), ("grind_kernel", "pow_grind"),
         # the scan, the batch inversion's two launches, DEEP, and the
         # generated group kernels (g0, g1, ... taking the Tabs struct of
         # air/codegen.py); an earlier checkout's scan in three passes
         # the Goldilocks / GF(p^3) route: the scan pair, DEEP, the dense
         # opener (templates on GLF / GL3F), before the Fp252 names
         ("scan_kernel<GL", "gl_scan_mul"),
         # the FRI fold and the coset scale and pad (templates on FPF, GLF
         # and GL3F), the affine pair scan
         ("fold_kernel<GL", "gl_fri_fold"), ("fold_kernel_occ<GL", "gl_fri_fold"),
         ("fold_kernel<FPF", "fp252_fri_fold"),
         ("scale_pad_kernel<GL", "gl_scale_pad"),
         ("scale_pad_kernel<FPF", "fp252_scale_pad"),
         ("affine_kernel", "fp252_affine_scan"),
         ("inv_tile_kernel<GL", "gl_batch_inv"),
         # an earlier checkout's two-launch batch inversion (--root)
         ("inv_forward_kernel<GL", "gl_batch_inv"),
         ("inv_backward_kernel<GL", "gl_batch_inv"),
         ("deep_kernel<GL", "gl_deep_compose"),
         # an earlier checkout's dense opener (--root)
         ("open_kernel<GL", "gl_open_dense"),
         ("reduce_kernel<GL", "gl_open_dense"),
         ("scan_kernel", "fp252_scan_mul"),
         ("inv_forward_kernel", "fp252_batch_inv"),
         ("inv_backward_kernel", "fp252_batch_inv"),
         ("totals_kernel", "fp252_scan_mul"), ("carry_kernel", "fp252_scan_mul"),
         ("apply_kernel", "fp252_scan_mul"), ("deep_kernel", "deep_compose"),
         # (a Goldilocks / GF(p^3) prove's group kernels are its field's,
         # air_group_gl / air_group_gl3 in the launch counts)
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


def profiled(fn):
    """fn() under torch.profiler (CPU and CUDA activity): (its wall ms,
    the trace's events, its device events: kernels, copies and sets)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace_path))
        events = json.loads(trace_path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return wall_ms, events, device


def device_ms_by_kernel(device):
    """{name: (device ms, count)} of device events: a kernel of the port by
    its C entry's name (SHORT), any other kernel by its own, copies and
    sets by their category."""
    by_name = {}
    for e in device:
        name = _short(e["name"]) if e["cat"] == "kernel" else e["cat"]
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e["dur"] / 1e3, n + 1)
    return by_name


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


def innermost_points(ranges):
    """The innermost span path along the timeline of nested ranges (start
    us, end us, name): sorted [(t, path)], path the names from the
    outermost range open from t on to the next point, () outside them."""
    points, stack = [], []

    def path():
        return tuple(name for _, _, name in stack)
    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][1] <= a:
            end = stack.pop()[1]
            points.append((end, path()))
        stack.append((a, b, name))
        points.append((a, path()))
    while stack:
        end = stack.pop()[1]
        points.append((end, path()))
    return points


def by_span(events, device, labels, top=10):
    """The profiled proves' device work and idle time by innermost program
    span (the recorder's record_function ranges): see the module's
    docstring.  labels: the prover's phase labels."""
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and not e["name"].startswith("ProfilerStep")]
    if not ranges:
        return {}
    points = innermost_points(ranges)
    times = [t for t, _ in points]

    def at(t):
        i = bisect.bisect_right(times, t) - 1
        return points[i][1] if i >= 0 else ()

    def key(path):
        return " > ".join(path[-3:]) if path else "(outside every span)"
    launched = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                    "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launched[corr] = e["ts"]
    table = {}
    for e in device:
        corr = e.get("args", {}).get("correlation")
        k = key(at(launched[corr])) if corr in launched \
            else "(not matched)"
        row = table.setdefault(k, [0.0, 0.0])
        row[0] += e["dur"] / 1e3
    lo = min(a for a, _, _ in ranges)
    hi = max(b for _, b, _ in ranges)
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps, t = [], lo
    for a, b in merged:
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    gaps = [(a, b) for a, b in gaps if b > a]
    idle_by_path, named = {}, []
    for g0, g1 in gaps:
        i = bisect.bisect_right(times, g0) - 1
        t, here = g0, {}
        while t < g1:
            path = points[i][1] if i >= 0 else ()
            nxt = times[i + 1] if i + 1 < len(times) else g1
            end = min(max(nxt, t), g1)
            idle_by_path[path] = idle_by_path.get(path, 0.0) + end - t
            here[path] = here.get(path, 0.0) + end - t
            t, i = end, i + 1
        named.append((g1 - g0, key(max(here, key=here.get)), g0, g1))
    for path, us in idle_by_path.items():
        table.setdefault(key(path), [0.0, 0.0])[1] += us / 1e3
    idle = sum(idle_by_path.values())
    loose = sum(us for path, us in idle_by_path.items()
                if not path or path[-1] == "prove" or path[-1] in labels)
    ranked = sorted(table.items(), key=lambda kv: -(kv[1][0] + kv[1][1]))
    longest = sorted(named, reverse=True)[:top]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]

    def host_ops(g0, g1, count=6):
        """The host's operators and runtime calls inside a gap, by the time
        they overlap it (nested operators each count)."""
        ops = {}
        for e in host:
            o = min(e["ts"] + e["dur"], g1) - max(e["ts"], g0)
            if o > 0:
                ops[e["name"]] = ops.get(e["name"], 0.0) + o / 1e3
        return sorted(ops.items(), key=lambda kv: -kv[1])[:count]
    return {"window_ms": (hi - lo) / 1e3, "idle_ms": idle / 1e3,
            "idle_unattributed": loose / idle if idle else 0.0,
            "idle_gaps": [[name, us / 1e3, host_ops(g0, g1)]
                          for us, name, g0, g1 in longest],
            "by_span": {k: {"device_ms": v[0], "idle_ms": v[1]}
                        for k, v in ranked}}


def span_cost_ns(telemetry, count: int = 100000) -> float:
    """The host cost of one span with no profiler: ns a span, nested in
    an open span of a request."""
    rid = telemetry.new_request()
    with telemetry.span("span_cost", request=rid):
        t0 = time.perf_counter_ns()
        for _ in range(count):
            with telemetry.span("x"):
                pass
        t1 = time.perf_counter_ns()
    return (t1 - t0) / count


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
    ap.add_argument("--steps", type=int, default=None,
                    help="VM steps of the claim (default: the layout's)")
    ap.add_argument("--options", default=None,
                    help="queries,blowup,grinding bits,folding factor,"
                         "remainder coefficients")
    ap.add_argument("--profiled", type=int, default=1,
                    help="proves under torch.profiler")
    ap.add_argument("--cprofile", type=int, default=0,
                    help="one more prove under cProfile: its N costliest "
                         "python functions by own time")
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
    steps = args.steps or STEPS[args.layout]
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
    options = ProofOptions(*(int(v) for v in args.options.split(","))) \
        if args.options else ProofOptions()
    mesh = None
    if args.mesh:
        from sandstorm_tpu_torch.parallel import dist, make_mesh
        mesh = make_mesh(args.mesh) if torch.cuda.device_count() >= \
            args.mesh > 1 else make_mesh(args.mesh, device=dev)

    requests = []

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
        requests.append(getattr(trace, "request", None))
        return proof, t1 - t0, t2 - t1

    proof, _, _ = one_prove()                       # warm-up: tables built
    blob = serialize_proof(proof)
    if args.proof_out:
        args.proof_out.write_bytes(blob)
    try:
        from sandstorm_tpu_torch import telemetry
    except ImportError:       # a checkout before the recorder (--root)
        telemetry = None
    torch.cuda.reset_peak_memory_stats(dev)
    walls, traces, engines = [], [], []
    increments = [0]
    for i in range(args.proves):
        if i == 0:
            _native.reset_counts()
            ntt_calls = dist.NTT_CALLS if mesh else 0
            if telemetry is not None:
                count = telemetry.count

                def counted(name, n=1):
                    increments[0] += 1
                    count(name, n)
                telemetry.count = counted
        _, tr, en = one_prove()
        if i == 0:
            launches = dict(_native.LAUNCHES)
            ntt_calls = (dist.NTT_CALLS - ntt_calls) if mesh else 0
            if telemetry is not None:
                telemetry.count = count
        walls.append(tr + en)
        traces.append(tr)
        engines.append(en)
    phases = [[k, v] for k, v in prover.LAST_PHASES]
    windows = dict(prover.LAST_CHUNKS)
    recorder = {}
    if telemetry is not None:
        req = telemetry.get(requests[-args.proves])
        recorder = {"spans_per_prove": len(req.spans),
                    "counter_increments_per_prove": increments[0],
                    "counts_per_prove": dict(req.counts()),
                    "span_cost_ns": span_cost_ns(telemetry)}
        recorder["span_cost_share_of_prove"] = (
            recorder["span_cost_ns"] * 1e-9 * len(req.spans)
            / statistics.median(walls))

    def profiled_proves():
        for _ in range(args.profiled):
            t0 = time.perf_counter()
            one_prove()
            profiled_walls.append(time.perf_counter() - t0)
    profiled_walls = []
    wall_ms, events, device = profiled(profiled_proves)
    python_line = {}
    if args.cprofile:
        import cProfile
        import pstats
        pr = cProfile.Profile()
        pr.runcall(one_prove)
        st = pstats.Stats(pr)
        rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])
        ours = sorted((kv for kv in st.stats.items()
                       if "sandstorm_tpu_torch" in kv[0][0]),
                      key=lambda kv: -kv[1][3])

        def line(rows):
            return [[f"{Path(f).name}:{n} {fn}", tt, ct, nc]
                    for (f, n, fn), (_, nc, tt, ct, _) in
                    rows[:args.cprofile]]
        python_line = {"cprofile_tottime_s": line(rows),
                       "cprofile_cumtime_s": line(ours)}
    by_name = device_ms_by_kernel(device)
    spans_line = by_span(events, device, {k for k, _ in phases})
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
        [kv for kv in ranked if kv[0] not in ours][:25]
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
        "profiled_proves": args.profiled,
        "profiled_prove_s": profiled_walls, "recorder": recorder,
        **spans_line, **python_line, **mesh_line}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
