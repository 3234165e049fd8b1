"""Claim assembly: a Cairo program + public input tied to a layout AIR, a
trace class, the field, a proof scheme and a device (port of
sandstorm_tpu/claims.py).  The port supports the plain layout, in the
252-bit field under the generic and the cairo scheme, and over Goldilocks
(GL) or with GF(p^3) challenges (GL3, the reference's fast-field
configuration) under the generic scheme; and the recursive layout (the
SHARP layout of StarkWare's Cairo verifier) in the 252-bit field under
both schemes."""

import numpy as np
import torch

from .binary.formats import AirPrivateInput, CairoWitness, Layout, Segment
from .fields.fp252 import Fp252
from .fields.gl3 import GL3
from .fields.goldilocks import GL
from .layouts.plain.air import PlainAirConfig
from .layouts.plain.trace import PlainExecutionTrace
from .layouts.recursive.air import RecursiveAirConfig
from .layouts.recursive.trace import RecursiveExecutionTrace
from .runner.vm import CairoVM, instr_assert_eq_imm, instr_jmp_rel_imm
from .stark.options import ProofOptions
from .stark.prover import prove as stark_prove
from .stark.scheme import get_scheme
from .stark.verifier import verify as stark_verify

_LAYOUTS = {
    Layout.PLAIN: (PlainAirConfig, PlainExecutionTrace),
    Layout.RECURSIVE: (RecursiveAirConfig, RecursiveExecutionTrace),
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
        if field not in (Fp252, GL, GL3):
            raise NotImplementedError(f"field {field} is not ported yet")
        if self.layout not in _LAYOUTS:
            raise NotImplementedError(
                f"layout {self.layout} is not ported yet")
        if self.layout == Layout.RECURSIVE and field is not Fp252:
            # the recursive AIR's Pedersen and bitwise columns hold 252-bit
            # felts, as in the JAX package
            raise NotImplementedError(
                "the recursive layout takes the 252-bit field only")
        self.air_config, self.trace_cls = _LAYOUTS[self.layout]
        self.scheme = get_scheme(scheme)
        if field is not Fp252 and self.scheme.name != "generic":
            # the cairo scheme's row hash reads the Montgomery form of a
            # 252-bit felt, as in the JAX package
            raise NotImplementedError(
                f"the {self.scheme.name} scheme takes the 252-bit field only")

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


def _loop_run(steps: int, layout):
    """The VM run of the claims below: registers, memory, public input."""
    vm = CairoVM([instr_assert_eq_imm(), 10, instr_jmp_rel_imm(), 0],
                 Fp252.MODULUS)
    trace, mem = vm.run(steps, initial_ap=6, extra_memory={5: 0})
    registers, memory = vm.to_witness_arrays(trace, mem)
    return registers, memory, vm.build_public_input(trace, mem, layout=layout)


def loop_claim(steps: int, device, scheme: str = "generic", field=Fp252):
    """A generated plain-layout claim and its witness: `[ap] = 10; ap++`
    followed by the `jmp rel 0` padding loop, run for `steps` VM steps (a
    power of two) from ap = fp = 6, proved in `field`.  At 16 steps in the
    252-bit field this is the claim of tests/data/self_proof_{generic,
    cairo}.bin under `scheme` (tools/gen_self_transcript.py); the
    plain-layout runs of bench.py build the same program.  The VM runs in
    the 252-bit field whatever `field` is, as the JAX package's Goldilocks
    tests run it (tests/test_e2e_plain.py).
    Returns (claim, witness)."""
    registers, memory, pub = _loop_run(steps, Layout.PLAIN)
    witness = CairoWitness(
        air_private_input=AirPrivateInput("", "", [], [], [], [], [], []),
        register_states=registers, memory=memory)
    claim = CairoClaim(None, pub, device=device, field=field,
                       layout=Layout.PLAIN, scheme=scheme)
    return claim, witness


def _made_up_instances(count: int, seed: int):
    """`count` builtin instances {"index", "x", "y"} with 251-bit inputs
    (below p, and with the bits a bitwise instance may use), made from
    `seed`."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        x, y = (int.from_bytes(rng.bytes(32), "big") >> 5 for _ in range(2))
        out.append({"index": i, "x": hex(x), "y": hex(y)})
    return out


def recursive_loop_claim(steps: int, device, scheme: str = "cairo",
                         pedersen: int = 3, bitwise: int = 3):
    """A generated recursive-layout claim and its witness: the program of
    loop_claim run for `steps` VM steps (a power of two, at least 16384:
    below it the diluted pool's padding does not fit the trace), with
    `pedersen` Pedersen and `bitwise` bitwise builtin instances made up
    from fixed seeds, so that the trace's real-instance code runs.  No
    128-bit range-check instance: its parts would move rc_min / rc_max off
    the VM's public input.

    The builtin segments follow the execution segment: pedersen (3 cells
    an instance slot, one slot per 2048 rows), range_check (one cell per
    128 rows), bitwise (5 cells per 128 rows), each stop_ptr past the
    instances it holds; the output segment is empty, at the pedersen
    segment's start (the cairo scheme's public input serialises it).  At
    16384 steps this is the size of the recursive run of bench.py (2^18
    rows, 93 constraints, LDE 2^19 at blowup 2).  Returns (claim,
    witness)."""
    registers, memory, pub = _loop_run(steps, Layout.RECURSIVE)
    n = steps * RecursiveAirConfig.CYCLE_HEIGHT
    base = max(max(e.address for e in pub.public_memory) + 2,
               int(registers.ap.max()) + 1)
    ped_begin = base
    rc_begin = ped_begin + 3 * (n // 2048)
    bw_begin = rc_begin + n // 128
    ped = _made_up_instances(pedersen, 1)
    bw = _made_up_instances(bitwise, 2)
    pub.memory_segments["output"] = Segment(ped_begin, ped_begin)
    pub.memory_segments["pedersen"] = Segment(ped_begin,
                                              ped_begin + 3 * len(ped))
    pub.memory_segments["range_check"] = Segment(rc_begin, rc_begin)
    pub.memory_segments["bitwise"] = Segment(bw_begin, bw_begin + 5 * len(bw))
    witness = CairoWitness(
        air_private_input=AirPrivateInput("", "", ped, [], [], bw, [], []),
        register_states=registers, memory=memory)
    claim = CairoClaim(None, pub, device=device, layout=Layout.RECURSIVE,
                       scheme=scheme)
    return claim, witness
