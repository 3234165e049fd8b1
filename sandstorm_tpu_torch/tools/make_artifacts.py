"""Write a cairo-run artifact bundle (trace.bin, memory.bin, program.json,
air-public-input.json, air-private-input.json) from one of the port's
generated claims, for driving the CLI without a cairo-lang toolchain (the
port's counterpart of tools/make_tiny_artifacts.py).

    python -m sandstorm_tpu_torch.tools.make_artifacts OUTDIR [STEPS] [KIND]

KIND is fp252 (default) or goldilocks: claims.loop_claim's plain-layout run
of STEPS steps (default 16), its memory values 32 or 8 bytes wide;
recursive: claims.recursive_loop_claim's run (STEPS at least 16384), with
its builtin segments and made-up Pedersen and bitwise instances; or
starknet: claims.starknet_loop_claim's run (STEPS at least 131072), with
made-up instances of every builtin.  The bundle loads
(examples.load_artifacts) to the claim's registers, memory, public input
and private input.
"""

import json
import os
import sys

import numpy as np

from ..binary.formats import AirPrivateInput, Layout
from ..claims import loop_run, recursive_loop_claim, starknet_loop_claim
from ..fields.fp252 import Fp252
from ..fields.goldilocks import GL
from ..runner.vm import instr_assert_eq_imm, instr_jmp_rel_imm

# the program of claims.loop_claim and claims.recursive_loop_claim
LOOP_PROGRAM = [instr_assert_eq_imm(), 10, instr_jmp_rel_imm(), 0]
PRIMES = {"fp252": Fp252.MODULUS, "goldilocks": GL.MODULUS}
_BUILTINS = ("pedersen", "range_check", "ecdsa", "bitwise", "ec_op",
             "poseidon")


def write_bundle(outdir, program_words, prime, registers, memory, pub,
                 priv: AirPrivateInput):
    """Write the five files of a bundle into outdir.  The private input
    names trace.bin and memory.bin by file name (load_artifacts finds them
    beside it).  Returns the paths {"program", "public", "private"}."""
    field_bytes = 32 if prime.bit_length() > 64 else 8
    if memory.values[:, field_bytes // 8:].any():
        raise ValueError(f"a memory value does not fit {field_bytes} bytes")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "trace.bin"), "wb") as f:
        f.write(np.ascontiguousarray(registers.arr, dtype="<u8").tobytes())
    addrs = np.nonzero(memory.known)[0]
    entries = np.zeros((len(addrs), 1 + field_bytes // 8), dtype="<u8")
    entries[:, 0] = addrs
    entries[:, 1:] = memory.values[addrs, :field_bytes // 8]
    with open(os.path.join(outdir, "memory.bin"), "wb") as f:
        f.write(entries.tobytes())
    paths = {name: os.path.join(outdir, file) for name, file in (
        ("program", "program.json"), ("public", "air-public-input.json"),
        ("private", "air-private-input.json"))}
    with open(paths["program"], "w") as f:
        json.dump({"data": [hex(w) for w in program_words],
                   "prime": hex(prime)}, f)
    with open(paths["public"], "w") as f:
        json.dump({
            "layout": pub.layout.value,
            "rc_min": pub.rc_min, "rc_max": pub.rc_max,
            "n_steps": pub.n_steps,
            "memory_segments": {
                name: {"begin_addr": s.begin_addr, "stop_ptr": s.stop_ptr}
                for name, s in pub.memory_segments.items()},
            "public_memory": [
                {"address": e.address, "value": hex(e.value), "page": 0}
                for e in pub.public_memory],
        }, f, indent=1)
    with open(paths["private"], "w") as f:
        json.dump({"trace_path": "trace.bin", "memory_path": "memory.bin",
                   **{name: getattr(priv, name) for name in _BUILTINS}},
                  f, indent=1)
    return paths


def loop_bundle(outdir, steps: int, field: str = "fp252"):
    """The bundle of claims.loop_claim(steps)'s run (plain layout) with the
    program's prime of `field` (fp252 or goldilocks)."""
    registers, memory, pub = loop_run(steps, Layout.PLAIN)
    priv = AirPrivateInput("", "", [], [], [], [], [], [])
    return write_bundle(outdir, LOOP_PROGRAM, PRIMES[field], registers,
                        memory, pub, priv)


def _claim_bundle(outdir, claim, witness):
    return write_bundle(outdir, LOOP_PROGRAM, Fp252.MODULUS,
                        witness.register_states, witness.memory,
                        claim.public_input, witness.air_private_input)


def recursive_bundle(outdir, steps: int):
    """The bundle of claims.recursive_loop_claim(steps)'s run (recursive
    layout, 252-bit field)."""
    return _claim_bundle(outdir, *recursive_loop_claim(steps, "cpu"))


def starknet_bundle(outdir, steps: int):
    """The bundle of claims.starknet_loop_claim(steps)'s run (starknet
    layout, 252-bit field)."""
    return _claim_bundle(outdir, *starknet_loop_claim(steps, "cpu"))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not 1 <= len(argv) <= 3:
        raise SystemExit(__doc__)
    outdir = argv[0]
    steps = int(argv[1]) if len(argv) > 1 else 16
    kind = argv[2] if len(argv) > 2 else "fp252"
    if kind == "recursive":
        recursive_bundle(outdir, steps)
    elif kind == "starknet":
        starknet_bundle(outdir, steps)
    elif kind in PRIMES:
        loop_bundle(outdir, steps, kind)
    else:
        raise SystemExit(f"unknown kind {kind!r}: fp252, goldilocks, "
                         f"recursive or starknet")
    print(f"wrote a {kind} bundle of {steps} steps to {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
