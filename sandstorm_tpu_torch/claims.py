"""Claim assembly: a Cairo program + public input tied to a layout AIR, a
trace class, the field, a proof scheme and a device (port of
sandstorm_tpu/claims.py).  The port supports the plain layout under the
generic and the cairo scheme."""

import torch

from .binary.formats import AirPrivateInput, CairoWitness, Layout
from .fields.fp252 import Fp252
from .layouts.plain.air import PlainAirConfig
from .layouts.plain.trace import PlainExecutionTrace
from .runner.vm import CairoVM, instr_assert_eq_imm, instr_jmp_rel_imm
from .stark.options import ProofOptions
from .stark.prover import prove as stark_prove
from .stark.scheme import get_scheme
from .stark.verifier import verify as stark_verify

_LAYOUTS = {
    Layout.PLAIN: (PlainAirConfig, PlainExecutionTrace),
}


class CairoClaim:
    """Program + public input + layout + field + proof scheme; proves on
    `device` (a torch device: the trace and every array of the prove live
    there)."""

    def __init__(self, program, public_input, *, device, field=Fp252,
                 layout=None, scheme=None):
        self.program = program
        self.public_input = public_input
        self.F = field
        self.device = torch.device(device)
        self.layout = layout or public_input.layout
        if field is not Fp252:
            raise NotImplementedError(f"field {field} is not ported yet")
        if self.layout not in _LAYOUTS:
            raise NotImplementedError(
                f"layout {self.layout} is not ported yet (plain only)")
        self.air_config, self.trace_cls = _LAYOUTS[self.layout]
        self.scheme = get_scheme(scheme)

    def generate_trace(self, witness):
        return self.trace_cls(self.F, self.program, self.public_input,
                              witness, self.device)

    def prove(self, witness, options: ProofOptions = None):
        return stark_prove(self.F, self.air_config,
                           self.generate_trace(witness), options,
                           scheme=self.scheme)

    def verify(self, proof, required_security_bits: int = 80) -> bool:
        return stark_verify(self.F, self.air_config, self.public_input,
                            proof, required_security_bits,
                            scheme=self.scheme)


def loop_claim(steps: int, device, scheme: str = "generic"):
    """A generated plain-layout claim and its witness: `[ap] = 10; ap++`
    followed by the `jmp rel 0` padding loop, run for `steps` VM steps (a
    power of two) from ap = fp = 6.  At 16 steps this is the claim of
    tests/data/self_proof_{generic,cairo}.bin under `scheme`
    (tools/gen_self_transcript.py); the plain-layout runs of bench.py build
    the same program.
    Returns (claim, witness)."""
    vm = CairoVM([instr_assert_eq_imm(), 10, instr_jmp_rel_imm(), 0],
                 Fp252.MODULUS)
    trace, mem = vm.run(steps, initial_ap=6, extra_memory={5: 0})
    registers, memory = vm.to_witness_arrays(trace, mem)
    pub = vm.build_public_input(trace, mem, layout=Layout.PLAIN)
    witness = CairoWitness(
        air_private_input=AirPrivateInput("", "", [], [], [], [], [], []),
        register_states=registers, memory=memory)
    claim = CairoClaim(None, pub, device=device, layout=Layout.PLAIN,
                       scheme=scheme)
    return claim, witness
