"""Time the witness of the three EC builtins on the host: the python route
against the native lockstep batch (native/ecdsa.cpp).

    python sandstorm_tpu_torch/tools/time_witness.py [--repeats R]
        [--root DIR --trace-only]

The instances are those of starknet-eth-2^21-ec: every Pedersen, ECDSA and
EC-op slot of claims.starknet_loop_claim(131072) (4096, 64 and 128,
claims.starknet_ec_counts).  For each builtin, host clock:

  python_s   the python `new` of every instance (the plain version);
  native_s   the raw batch (native.*_witness_batch on limbs packed
             beforehand, a signature's public key with the y that
             verifies), one call a chunk of WITNESS_CHUNK instances;
  handoff_s  witness_limbs over the same chunks: the batch with its
             hand-off to the trace builders (packing, the public keys'
             y, a second call for those whose y is the other root,
             column views, the suffix columns, the checks);

then the whole trace build (claim.generate_trace, host numpy, nothing on
a device) of starknet-eth-2^21 and of starknet-eth-2^21-ec, with the
builder's seconds a builtin (witness and column fill) and the native
batch's share of them.  The native and trace times are the median of
`--repeats` runs after a warm-up.  Prints the card's name and power limit
where nvidia-smi answers, then one JSON line with the host CPU's model and
core count.  `--root` imports sandstorm_tpu_torch from another checkout
of this repository (run the script by its path) and `--trace-only` times
the two trace builds alone, so that one call can time a parent commit,
whose builders take the python route, and a change on the same host.
Nothing runs at import.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

STEPS = 1 << 17


def median_s(fn, repeats):
    """Median host seconds of fn() over `repeats` calls after a warm-up."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def cpu_model() -> str:
    """The first processor's model name, vendor, family and model number
    as /proc/cpuinfo gives them (a virtual machine may name no model)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        return "unknown"
    return ", ".join(f"{k} {fields[k]}" for k in (
        "model name", "vendor_id", "cpu family", "model") if k in fields)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


# starknet-eth-2^21-ec's counts (claims.starknet_ec_counts(STEPS)), for
# a checkout that predates it
EC_COUNTS = {"pedersen": 4096, "ecdsa": 64, "ec_op": 128}


BATCHED = ("pedersen", "ecdsa", "ec_op")


def builtin_seconds(trace, seconds, telemetry):
    """A trace build's seconds a builtin of the native batch and its
    batch's own seconds: its trace.builtin.* and native.* spans, or in a
    checkout before the recorder (telemetry None) the trace's witness_s
    and native.SECONDS."""
    if telemetry is None:
        return dict(getattr(trace, "witness_s", {})), dict(seconds)
    req = telemetry.get(trace.request)
    return ({k: req.seconds(f"trace.builtin.{k}") for k in BATCHED},
            {f"{k}_witness_batch": req.seconds(f"native.{k}_witness_batch")
             for k in BATCHED})


def trace_builds(repeats: int) -> dict:
    """The trace build of starknet-eth-2^21 and of starknet-eth-2^21-ec:
    every run's seconds, their median, and the middle run's seconds a
    builtin and its native batch's (where the checkout records them)."""
    import numpy as np
    from sandstorm_tpu_torch import claims, native
    try:
        from sandstorm_tpu_torch import telemetry
    except ImportError:
        telemetry = None
    ec_counts = getattr(claims, "starknet_ec_counts", lambda s: EC_COUNTS)
    seconds = getattr(native, "SECONDS", {})
    traces = {}
    for label, counts in (("starknet-eth-2^21", {}),
                          ("starknet-eth-2^21-ec", ec_counts(STEPS))):
        c, w = claims.starknet_loop_claim(STEPS, "cpu", **counts)
        runs = []
        for _ in range(repeats + 1):
            seconds.clear()
            t0 = time.perf_counter()
            trace = c.generate_trace(w)
            runs.append((time.perf_counter() - t0,
                         *builtin_seconds(trace, seconds, telemetry)))
            del trace
        runs = runs[1:]
        walls = [r[0] for r in runs]
        mid = runs[int(np.argsort(walls)[len(walls) // 2])]
        traces[label] = {"trace_build_s": walls,
                         "median_s": statistics.median(walls),
                         "witness_s": mid[1], "native_s": mid[2]}
    return traces


def measure(repeats: int = 3) -> dict:
    from sandstorm_tpu_torch import native
    from sandstorm_tpu_torch.builtins import ec_op, ecdsa, pedersen
    from sandstorm_tpu_torch.claims import (starknet_ec_counts,
                                            starknet_loop_claim)
    from sandstorm_tpu_torch.layouts.starknet.trace import witness_items
    from sandstorm_tpu_torch.layouts.utils import (ints_to_u64limbs,
                                                   witness_chunks)

    t0 = time.perf_counter()
    claim, witness = starknet_loop_claim(STEPS, "cpu",
                                         **starknet_ec_counts(STEPS))
    claim_s = time.perf_counter() - t0
    items = witness_items(witness.air_private_input)

    def packed(name, chunk):
        """The raw batch's inputs of one chunk, as limbs."""
        if name == "pedersen":
            return [ints_to_u64limbs(it[j] for it in chunk) for j in (1, 2)]
        if name == "ecdsa":
            # with the y that verifies: one lockstep run, no second call
            cols = [ints_to_u64limbs(it[j] for it in chunk)
                    for j in (2, 3, 4, 1)]
            return cols + [ecdsa.witness_limbs(chunk).pubkey_y]
        return [ints_to_u64limbs(it[j] for it in chunk) for j in range(1, 6)]

    routes = {"pedersen": (pedersen, native.pedersen_witness_batch),
              "ecdsa": (ecdsa, native.ecdsa_witness_batch),
              "ec_op": (ec_op, native.ec_op_witness_batch)}
    builtins = {}
    for name, (module, batch) in routes.items():
        todo = items[name]
        inputs = [packed(name, c) for c in witness_chunks(todo)]
        t0 = time.perf_counter()
        for it in todo:
            module.InstanceTrace.new(*it)
        python_s = time.perf_counter() - t0
        native_s = median_s(lambda: [batch(*x) for x in inputs], repeats)
        handoff_s = median_s(lambda: [module.witness_limbs(c) for c in
                                      witness_chunks(todo)], repeats)
        builtins[name] = {"instances": len(todo), "python_s": python_s,
                          "native_s": native_s, "handoff_s": handoff_s,
                          "python_over_handoff": python_s / handoff_s}

    return {"phase": "time_witness", "claim_ec_s": claim_s,
            "host_cpu": cpu_model(), "cpu_count": os.cpu_count(),
            "builtins": builtins, "trace_build": trace_builds(repeats)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--trace-only", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    smi = nvidia_smi()
    if smi:
        print(smi, flush=True)
    if args.trace_only:
        line = {"phase": "time_witness_traces", "root": args.root,
                "host_cpu": cpu_model(), "cpu_count": os.cpu_count(),
                "trace_build": trace_builds(args.repeats)}
    else:
        line = measure(args.repeats)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
