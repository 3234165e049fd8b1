"""Run one cell of the benchmark of sandstorm_tpu_torch once, on one card.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell is a configuration (a claim: layout, scheme, trace length, builtin
instances) under a traffic mix (the proof options a client asks for), as
BENCHMARK.json names them.  The deployment it stands for is one warm
prover process on one card proving jobs one after another: a closed loop
with one client.

Set-up, timed from the start of the process: the imports, the kernel
library's load (its build with nvcc in a checkout's first run), the VM runs
and the bundles of a pool of jobs drawn from --seed (into TMPDIR), and one
warm-up proof, which builds the tables and the generated kernels.  Then
the window: jobs of the pool in turn, each from its files on disk to the
proof bytes in memory through the calls the CLI's prove makes (the
bundle's load, the claim, the trace build, the engine's prove, the ark
serialization), until --seconds have passed; the proof running then is
finished and the window stretched to its end.  With --trace 1 two more
proofs run under torch.profiler after the window.

Then, once the program's state is freed, the plain reference verifier
(portbench/reference) judges a sample of the window's proofs drawn from
the seed: each must be a valid proof of its job's claim at the job's
options and the configuration's security.  The last line of standard
output is the result as JSON; the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key.

Exits 2 with no result without as many CUDA cards as the cell asks for,
and 3 with no result if jax, jaxlib, flax or the JAX package sandstorm_tpu
was imported.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells, yardstick  # noqa: E402
from portbench.gen import bundle  # noqa: E402

BENCH_JSON = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "sandstorm_tpu")
PROFILED_PROOFS = 2
SPAN = "portbench."


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def say(*parts):
    print(*parts, flush=True)


def _gpu_facts(torch, device):
    """The card's name, SM count, maximum SM clock and power limit."""
    props = torch.cuda.get_device_properties(device)
    smi = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=clocks.max.sm,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    clock_mhz, power_w = (float(v) for v in smi.split(","))
    return {"name": torch.cuda.get_device_name(device),
            "sm_count": props.multi_processor_count,
            "max_sm_clock_hz": clock_mhz * 1e6, "power_limit_w": power_w}


class Program:
    """The calls of sandstorm_tpu_torch that a job goes through, looked up
    on their modules at each call."""

    def __init__(self, device):
        import torch
        from sandstorm_tpu_torch import claims, examples
        from sandstorm_tpu_torch.stark import ark, options, prover
        self.torch, self.claims, self.examples = torch, claims, examples
        self.ark, self.options, self.prover = ark, options, prover
        self.device = device

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def job(self, paths, scheme, options, span=None):
        """One job from its files to its proof bytes: (bytes, timings)."""
        span = span or (lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        with span("load"):
            program, pub, witness = self.examples.load_artifacts(
                paths["program"], paths["public"], paths["private"])
            claim = self.claims.CairoClaim(program, pub, device=self.device,
                                           scheme=scheme)
        t1 = time.perf_counter()
        with span("trace_build"):
            trace = claim.generate_trace(witness)
            self.sync()
        t2 = time.perf_counter()
        with span("prove"):
            proof = self.prover.prove(claim.F, claim.air_config, trace,
                                      options, scheme=claim.scheme)
            self.sync()
        t3 = time.perf_counter()
        with span("serialize"):
            blob = self.ark.serialize_proof(proof)
        t4 = time.perf_counter()
        return blob, {"start": t0, "end": t4, "wall_s": t4 - t0,
                      "load_s": t1 - t0, "trace_build_s": t2 - t1,
                      "engine_s": t3 - t2, "serialize_s": t4 - t3,
                      "phases": [[k, v] for k, v in self.prover.LAST_PHASES]}


def profile_proofs(prog, jobs, first, scheme, options, count, tmpdir):
    """`count` jobs from jobs[first] on under torch.profiler, each stage in
    a record_function span: the trace's device events, the spans, each
    prove's phases, and the profiled wall (us)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if prog.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    phases = []
    with profile(activities=activities) as prof:
        with record_function(SPAN + "window"):
            for k in range(count):
                _, timing = prog.job(
                    jobs[(first + k) % len(jobs)], scheme, options,
                    span=lambda name: record_function(SPAN + name))
                phases.append(timing["phases"])
            prog.sync()
    path = Path(tmpdir) / "trace.json"
    prof.export_chrome_trace(str(path))
    trace_bytes = path.stat().st_size
    events = json.loads(path.read_text())
    path.unlink()
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = sorted(({"name": e["name"][len(SPAN):], "ts": e["ts"],
                     "dur": e["dur"]} for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith(SPAN)),
                   key=lambda s: s["ts"])
    window = next(s for s in spans if s["name"] == "window")
    return {"device": yardstick.device_events(events), "spans": spans,
            "phases": phases, "proofs": count, "trace_bytes": trace_bytes,
            "start_us": window["ts"], "wall_us": window["dur"]}


def run_cell(bench_path, workload, seed, seconds, trace, device,
             t_process=None):
    """Set up, run the window and judge the sample; returns the result."""
    t_process = T_PROCESS if t_process is None else t_process
    spec = cells.cell(bench_path, workload)
    config, traffic = spec["config"], spec["traffic"]
    scheme, opts = config["scheme"], traffic["options"]
    setup = {}
    t = time.perf_counter()
    prog = Program(device)
    torch = prog.torch
    options = prog.options.ProofOptions(**opts)
    setup["imports_s"] = time.perf_counter() - t_process
    t = time.perf_counter()
    gpu = None
    if device.type == "cuda":
        from sandstorm_tpu_torch import _native
        _native.lib()
        gpu = _gpu_facts(torch, device)
    setup["kernel_load_s"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmpdir:
        jobs, setup["vm_s"], setup["bundles_s"] = bundle.make_pool(
            config, seed, tmpdir, config["jobs_in_pool"])
        t = time.perf_counter()
        prog.job(jobs[0], scheme, options)
        setup["warm_up_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_process
        say(json.dumps({"setup": setup, "setup_s": setup_s,
                        "gpu": gpu}))

        # -- the window
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        blobs, proofs, failed = [], [], 0
        start = time.perf_counter()
        k = 1
        while True:
            job = k % len(jobs)
            try:
                blob, timing = prog.job(jobs[job], scheme, options)
            except Exception:
                failed += 1
                traceback.print_exc()
                timing, blob = None, None
            if timing is not None:
                timing["job"] = job
                proofs.append(timing)
                blobs.append((job, blob))
            k += 1
            if time.perf_counter() - start >= seconds:
                break
        prog.sync()
        end = time.perf_counter()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)
        profile = None
        if trace:
            profile = profile_proofs(prog, jobs, k, scheme, options,
                                     PROFILED_PROOFS, tmpdir)
        del prog
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        record = {"setup_s": setup_s, "setup": setup, "gpu": gpu,
                  "config": config, "traffic": traffic,
                  "peak_bytes": peak, "profile": profile,
                  "window": {"start": start, "end": end, "proofs": proofs,
                             "failed": failed}}
        say(json.dumps({"window_s": end - start, "proofs": len(proofs),
                        "failed": failed,
                        "walls_s": [p["wall_s"] for p in proofs],
                        "mean_s": _means(proofs),
                        "trace_bytes": profile and profile["trace_bytes"]}))
        checks = judge(config, traffic, jobs, blobs, seed)
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = cells.reader(bench_path, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {"failed": {"value": failed, "limit": 0}, **checks}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": len(proofs) + failed, "failed": failed,
              "metrics": metrics,
              "device": _device_line(torch, device, peak, profile, gpu)}
    if profile is not None and device.type == "cuda":
        result["breakdown"] = breakdown(profile)
    result["checks"] = checks
    return result


def _means(proofs):
    """Each stage's and each prover phase's mean seconds over the proofs."""
    sums = {}
    for p in proofs:
        for key in ("load_s", "trace_build_s", "engine_s", "serialize_s"):
            sums[key] = sums.get(key, 0.0) + p[key]
        for label, seconds in p["phases"]:
            sums[label] = sums.get(label, 0.0) + seconds
    return {k: v / len(proofs) for k, v in sums.items()} if proofs else {}


def _device_line(torch, device, peak, profile, gpu):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    line = {"platform": "gpu", "kind": gpu["name"],
            "count": 1, "memory_peak_bytes": peak}
    if profile is not None:
        line["busy_s"] = yardstick.busy_ms(profile["device"]) / 1e3
        line["window_s"] = profile["wall_us"] / 1e6
    return line


def breakdown(profile):
    """The device operations that took most time, and the longest idle gaps,
    each named by the benchmark's span (or, inside a prove, the prover's
    phase) that covers most of it."""
    ranked = sorted(yardstick.device_ms_by_kernel(profile["device"]).items(),
                    key=lambda kv: -kv[1][0])
    ops = [[name, ms / 1e3] for name, (ms, _) in ranked[:10]]
    marks = []
    proves = [s for s in profile["spans"] if s["name"] == "prove"]
    for s in profile["spans"]:
        if s["name"] not in ("window", "prove"):
            marks.append((s["ts"], s["ts"] + s["dur"], s["name"]))
    for s, phases in zip(proves, profile["phases"]):
        for label, a, b in yardstick.phase_intervals(s["ts"], phases):
            marks.append((a, b, f"prove: {label}"))
    busy = yardstick.busy_intervals(profile["device"])
    lo = profile["start_us"]
    gaps = sorted(yardstick.idle_gaps(busy, lo, lo + profile["wall_us"]),
                  key=lambda g: -g[1])[:10]

    def where(a, length):
        """The span or phase that covers most of the gap."""
        best, name = 0.0, "between jobs"
        for lo_m, hi_m, mark in marks:
            overlap = min(hi_m, a + length) - max(lo_m, a)
            if overlap > best:
                best, name = overlap, mark
        return name
    return {"device_ops": ops,
            "idle_gaps": [[where(a, length), length / 1e6]
                          for a, length in gaps]}


def judge(config, traffic, jobs, blobs, seed):
    """The reference verifier over a sample of the window's proofs drawn
    from the seed: the numbers compared, each {"value", "limit"}: the
    proofs it rejected, and 1 if there was no proof to judge."""
    import numpy as np
    from portbench.reference import verify as reference
    from portbench.reference.public_input import (AirPublicInput,
                                                  program_words)
    t = time.perf_counter()
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64),
                                                        1 << 20]))
    count = min(config["proofs_checked"], len(blobs))
    sample = sorted(rng.choice(len(blobs), size=count, replace=False)) \
        if count else []
    rejected = 0
    for i in sample:
        job, blob = blobs[i]
        pub = AirPublicInput.from_json(jobs[job]["public"])
        program, _ = program_words(jobs[job]["program"])
        try:
            reference.verify(blob, pub, program, config["scheme"],
                             traffic["options"], config["security_bits"])
        except reference.Rejected as e:
            rejected += 1
            print(f"reference: proof {i} (job {job}) rejected: {e}",
                  file=sys.stderr, flush=True)
    say(json.dumps({"reference_s": time.perf_counter() - t,
                    "checked": [int(i) for i in sample]}))
    return {"unchecked": {"value": int(count == 0), "limit": 0},
            "rejected": {"value": rejected, "limit": 0}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = cells.cell(BENCH_JSON, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} CUDA card(s), "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(BENCH_JSON, args.workload, args.seed, args.seconds,
                      args.trace, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run imported {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    say(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
