"""Loading a cairo-run artifact bundle (port of sandstorm_tpu/examples.py,
the reference CLI's input path, cli/src/main.rs:180-199): program JSON,
AIR public input JSON and AIR private input JSON, whose trace and memory
files make the witness."""

import os

from . import telemetry
from .binary.formats import (AirPrivateInput, AirPublicInput, CairoWitness,
                             CompiledProgram, Memory, RegisterStates)


def load_artifacts(program_path, public_input_path, private_input_path,
                   base_dir=None):
    """(program, public input, witness) of a bundle.  The private input's
    trace and memory paths are taken as written when absolute and present,
    else by their file name (then as written) under base_dir, by default
    the private input's directory.  Memory values are 32 bytes for a prime
    above 2^64 and 8 bytes (Goldilocks) otherwise.  The load is the span
    "load" of a new request, which the public input carries to its claim."""
    request = telemetry.new_request()
    with telemetry.span("load", request=request):
        program, pub, witness = _load(program_path, public_input_path,
                                      private_input_path, base_dir)
    pub.request = request
    return program, pub, witness


def _load(program_path, public_input_path, private_input_path, base_dir):
    program = CompiledProgram.from_json(program_path)
    pub = AirPublicInput.from_json(public_input_path)
    priv = AirPrivateInput.from_json(private_input_path)
    base = base_dir or os.path.dirname(os.path.abspath(private_input_path))

    def _resolve(p):
        if os.path.isabs(p) and os.path.exists(p):
            return p
        cand = os.path.join(base, os.path.basename(p))
        if os.path.exists(cand):
            return cand
        return os.path.join(base, p)

    registers = RegisterStates.from_file(_resolve(priv.trace_path))
    field_bytes = 32 if program.prime.bit_length() > 64 else 8
    memory = Memory.from_file(_resolve(priv.memory_path), field_bytes)
    witness = CairoWitness(air_private_input=priv, register_states=registers,
                           memory=memory)
    return program, pub, witness
