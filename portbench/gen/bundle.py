"""Jobs: cairo-run artifact bundles (trace.bin, memory.bin, program.json,
air-public-input.json, air-private-input.json) drawn from a seed.

A job is the loop program `[ap] = imm; ap++` then the `jmp rel 0` padding
loop (the port's claims.loop_run, with the immediate drawn from the seed so
that every job is a claim of its own), run for the configuration's n_steps
from ap = fp = 6, with the builtin segments of its layout laid out after the
execution segment as the port's claims.recursive_loop_claim and
starknet_loop_claim lay them out, and as many instances of each builtin,
drawn from the seed, as the configuration says.  The files are written as
the port's tools/make_artifacts.py writes them.
"""

import json
import os
import time

import numpy as np

from ..reference.field import P
from . import instances
from .vm import CairoVM, instr_assert_eq_imm, instr_jmp_rel_imm

CYCLE_HEIGHT = 16
BUILTINS = ("pedersen", "range_check", "ecdsa", "bitwise", "ec_op",
            "poseidon")
# (cells an instance, trace rows an instance slot) of each builtin segment,
# in the order the segments follow the execution segment
SEGMENTS = {
    "plain": {},
    "recursive": {"pedersen": (3, 2048), "range_check": (1, 128),
                  "bitwise": (5, 128)},
    "starknet": {"pedersen": (3, 512), "range_check": (1, 256),
                 "ecdsa": (2, 32768), "bitwise": (5, 1024),
                 "ec_op": (7, 16384), "poseidon": (6, 512)},
}


def _rng(seed: int, job: int, stream: int):
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), job, stream]))


def vm_run(config: dict, seed: int, job: int):
    """The job's program and VM run: (program words, registers [n, 3],
    memory (addresses, [k, 4] u64 words), public input JSON object)."""
    imm = instances.draw(_rng(seed, job, 0), P)
    program = [instr_assert_eq_imm(), imm, instr_jmp_rel_imm(), 0]
    vm = CairoVM(program, P)
    trace, mem = vm.run(config["n_steps"], initial_ap=6,
                        extra_memory={5: 0})
    registers, memory = vm.to_witness_arrays(trace, mem)
    return program, registers, memory, vm.build_public_input(
        trace, mem, config["layout"])


def builtin_instances(config: dict, seed: int, job: int, pub: dict,
                      registers):
    """The private input's instance lists, and the builtin segments added to
    the public input `pub` (in place)."""
    counts = config.get("builtins", {})
    sizes = SEGMENTS[config["layout"]]
    unknown = set(counts) - set(sizes)
    if unknown:
        raise ValueError(f"the {config['layout']} layout has no builtin "
                         f"{sorted(unknown)}")
    n = config["n_steps"] * CYCLE_HEIGHT
    made = {name: [] for name in BUILTINS}
    for k, name in enumerate(BUILTINS, start=1):
        count = counts.get(name, 0)
        if not count:
            continue
        rng = _rng(seed, job, k)
        if name in ("pedersen", "bitwise"):
            made[name] = instances.hash_inputs(rng, count)
        elif name == "range_check":
            made[name] = instances.rc128(rng, count, pub["rc_min"],
                                         pub["rc_max"])
        elif name == "ecdsa":
            made[name] = instances.signatures(rng, count)
        elif name == "ec_op":
            made[name] = instances.ec_ops(rng, count)
        else:
            made[name] = instances.poseidons(rng, count)
    if sizes:
        segments = pub["memory_segments"]
        base = max(max(e["address"] for e in pub["public_memory"]) + 2,
                   int(registers[:, 0].max()) + 1)
        segments["output"] = {"begin_addr": base, "stop_ptr": base}
        begin = base
        for name, (cells, rows) in sizes.items():
            if len(made[name]) > n // rows:
                raise ValueError(f"{len(made[name])} {name} instances, "
                                 f"{n // rows} slots")
            segments[name] = {"begin_addr": begin,
                              "stop_ptr": begin + cells * len(made[name])}
            begin += cells * (n // rows)
    return made


def write_bundle(outdir, program, registers, memory, pub, made):
    """The five files of a bundle; returns their paths {"program",
    "public", "private"}.  The private input names trace.bin and memory.bin
    by file name (the loader finds them beside it)."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "trace.bin"), "wb") as f:
        f.write(np.ascontiguousarray(registers, dtype="<u8").tobytes())
    addrs, values = memory
    entries = np.zeros((len(addrs), 5), dtype="<u8")
    entries[:, 0] = addrs
    entries[:, 1:] = values
    with open(os.path.join(outdir, "memory.bin"), "wb") as f:
        f.write(entries.tobytes())
    paths = {name: os.path.join(outdir, file) for name, file in (
        ("program", "program.json"), ("public", "air-public-input.json"),
        ("private", "air-private-input.json"))}
    with open(paths["program"], "w") as f:
        json.dump({"data": [hex(w) for w in program], "prime": hex(P)}, f)
    with open(paths["public"], "w") as f:
        json.dump(pub, f, indent=1)
    with open(paths["private"], "w") as f:
        json.dump({"trace_path": "trace.bin", "memory_path": "memory.bin",
                   **made}, f, indent=1)
    return paths


def make_pool(config: dict, seed: int, root, count: int):
    """`count` jobs of the configuration drawn from `seed`, each in its own
    directory under root.  Returns (the jobs' paths, seconds in the VM runs,
    seconds drawing instances and writing the bundles)."""
    jobs, vm_s, bundle_s = [], 0.0, 0.0
    for job in range(count):
        t0 = time.perf_counter()
        program, registers, memory, pub = vm_run(config, seed, job)
        t1 = time.perf_counter()
        made = builtin_instances(config, seed, job, pub, registers)
        jobs.append(write_bundle(os.path.join(root, f"job{job}"), program,
                                 registers, memory, pub, made))
        t2 = time.perf_counter()
        vm_s += t1 - t0
        bundle_s += t2 - t1
    return jobs, vm_s, bundle_s
