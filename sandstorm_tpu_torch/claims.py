"""Claim assembly: a Cairo program + public input tied to a layout AIR, a
trace class, the field, a proof scheme and a device (port of
sandstorm_tpu/claims.py).  The port supports the plain layout, in the
252-bit field under the generic, eth and cairo schemes, over Goldilocks
(GL) under the generic and cairo schemes, and with GF(p^3) challenges
(GL3, the reference's fast-field configuration) under the generic scheme;
and the recursive layout (the SHARP layout of StarkWare's Cairo verifier)
and the starknet layout (the bootloader's, every builtin) in the 252-bit
field under all three.
EthVerifierClaim and CairoVerifierClaim are the reference's claims for
StarkWare's two verifiers."""

import numpy as np
import torch

from .binary.formats import AirPrivateInput, CairoWitness, Layout, Segment
from .builtins import curve
from .builtins import ec_op as ec_op_builtin
from .builtins import ecdsa as ecdsa_builtin
from .fields.fp252 import Fp252
from .fields.gl3 import GL3
from .fields.goldilocks import GL
from .layouts.plain.air import PlainAirConfig
from .layouts.plain.trace import PlainExecutionTrace
from .layouts.recursive.air import RecursiveAirConfig
from .layouts.recursive.trace import RecursiveExecutionTrace
from .layouts.starknet.air import StarknetAirConfig
from .layouts.starknet.trace import StarknetExecutionTrace
from .runner.vm import CairoVM, instr_assert_eq_imm, instr_jmp_rel_imm
from .stark.options import ProofOptions
from .stark.prover import prove as stark_prove
from .stark.scheme import get_scheme
from .stark.verifier import verify as stark_verify

_LAYOUTS = {
    Layout.PLAIN: (PlainAirConfig, PlainExecutionTrace),
    Layout.RECURSIVE: (RecursiveAirConfig, RecursiveExecutionTrace),
    Layout.STARKNET: (StarknetAirConfig, StarknetExecutionTrace),
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
                f"the {self.layout.value} layout is not ported yet")
        if self.layout != Layout.PLAIN and field is not Fp252:
            # the recursive and starknet AIRs' builtin columns hold 252-bit
            # felts and curve points, as in the JAX package
            raise NotImplementedError(
                f"the {self.layout.value} layout takes the 252-bit field "
                f"only")
        self.air_config, self.trace_cls = _LAYOUTS[self.layout]
        self.scheme = get_scheme(scheme)
        if field is not Fp252 and self.scheme.name != "generic" \
                and not (field is GL and self.scheme.name == "cairo"):
            # the cairo scheme reads a GL value as the Stark252 felt of the
            # same integer; the JAX package's own runs of eth over GL or
            # GL3 and of cairo over GL3 fail, so the port refuses them
            raise NotImplementedError(
                f"the {self.scheme.name} scheme over {field.NAME} is not "
                f"ported")

    def generate_trace(self, witness):
        return self.trace_cls(self.F, self.program, self.public_input,
                              witness, self.device)

    def prove(self, witness, options: ProofOptions = None, mesh=None):
        """The proof of `witness`; with `mesh` (parallel.make_mesh or
        multihost.global_mesh) the transforms run over its shards."""
        return stark_prove(self.F, self.air_config,
                           self.generate_trace(witness), options,
                           scheme=self.scheme, mesh=mesh)

    def verify(self, proof, required_security_bits: int = 80) -> bool:
        return stark_verify(self.F, self.air_config, self.public_input,
                            proof, required_security_bits,
                            scheme=self.scheme)


def EthVerifierClaim(program, public_input, *, device, field=Fp252,
                     layout=None):
    """LeafVariant(MaskedKeccak256<20>) + the Solidity coin: the claim whose
    proofs target StarkWare's Ethereum verifier (src/claims.rs:12-21)."""
    return CairoClaim(program, public_input, device=device, field=field,
                      layout=layout, scheme="eth")


def CairoVerifierClaim(program, public_input, *, device, field=Fp252,
                       layout=None):
    """FriendlyMerkleTree<22, Pedersen> + the Cairo coin: the claim whose
    proofs target StarkWare's Cairo verifier (src/claims.rs:23-33)."""
    return CairoClaim(program, public_input, device=device, field=field,
                      layout=layout, scheme="cairo")


def loop_run(steps: int, layout):
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
    eth, cairo}.bin under `scheme` (tools/gen_self_transcript.py); the
    plain-layout runs of bench.py build the same program.  The VM runs in
    the 252-bit field whatever `field` is, as the JAX package's Goldilocks
    tests run it (tests/test_e2e_plain.py).
    Returns (claim, witness)."""
    registers, memory, pub = loop_run(steps, Layout.PLAIN)
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
    registers, memory, pub = loop_run(steps, Layout.RECURSIVE)
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


def _draw(rng, bound: int) -> int:
    """A python int below `bound` (at most 2^256) from a numpy generator."""
    return int.from_bytes(rng.bytes(32), "big") % bound


def _made_up_signatures(count: int, seed: int):
    """`count` ECDSA instances {"index", "pubkey", "msg", "signature_input":
    {"r", "w"}} signed by one private key with nonces drawn from `seed`,
    each checked by ecdsa.verify (the AIR's formula)."""
    rng = np.random.default_rng(seed)
    priv = _draw(rng, curve.FR - 1) + 1
    pub_x = curve.ec_mul(priv, curve.GENERATOR)[0]
    out = []
    while len(out) < count:
        msg = _draw(rng, 1 << 251)
        sig = ecdsa_builtin.sign(priv, msg, _draw(rng, curve.FR - 1) + 1)
        if msg == 0 or sig is None \
                or ecdsa_builtin.verify(msg, *sig, pub_x) is None:
            continue
        out.append({"index": len(out), "pubkey": hex(pub_x),
                    "msg": hex(msg), "signature_input": {
                        "r": hex(sig[0]), "w": hex(sig[1])}})
    return out


def _made_up_ec_ops(count: int, seed: int):
    """`count` EC-op instances {"index", "p_x", "p_y", "q_x", "q_y", "m"}:
    p and q multiples of the generator by scalars drawn from `seed`, and a
    251-bit m that ec_op.mimic_ec_mad_air accepts."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        p = curve.ec_mul(_draw(rng, curve.FR - 1) + 1, curve.GENERATOR)
        q = curve.ec_mul(_draw(rng, curve.FR - 1) + 1, curve.GENERATOR)
        m = _draw(rng, 1 << 251)
        if ec_op_builtin.mimic_ec_mad_air(m, q, p) is None:
            continue
        out.append({"index": len(out), "p_x": hex(p[0]), "p_y": hex(p[1]),
                    "q_x": hex(q[0]), "q_y": hex(q[1]), "m": hex(m)})
    return out


def _made_up_poseidons(count: int, seed: int):
    """`count` Poseidon instances {"index", "input_s0..2"}, inputs below
    p, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    return [{"index": i, **{f"input_s{k}": hex(_draw(rng, Fp252.MODULUS))
                            for k in range(3)}} for i in range(count)]


def _made_up_rc128(count: int, seed: int, lo: int, hi: int):
    """`count` 128-bit range-check instances {"index", "value"} whose eight
    16-bit parts are drawn from [lo, hi] with `seed`: inside the VM's own
    offset range, they leave rc_min and rc_max as they are."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        parts = rng.integers(lo, hi + 1, size=8)
        value = 0
        for part in parts:
            value = (value << 16) | int(part)
        out.append({"index": i, "value": hex(value)})
    return out


def starknet_ec_counts(steps: int) -> dict:
    """The instance counts of starknet-eth-2^21-ec's claim at `steps`: every
    slot of the builtins the native witness batch serves, one Pedersen
    instance per 512 rows, one signature per 32768, one EC op per 16384
    (the ratios of starknet_loop_claim's segments); 4096, 64 and 128 at
    131072 steps.  The other builtins keep the stand-in's counts."""
    n = steps * StarknetAirConfig.CYCLE_HEIGHT
    return {"pedersen": n // 512, "ecdsa": n // 32768, "ec_op": n // 16384}


def starknet_loop_claim(steps: int, device, scheme: str = "eth",
                        pedersen: int = 3, range_check: int = 2,
                        ecdsa: int = 2, bitwise: int = 3, ec_op: int = 2,
                        poseidon: int = 3):
    """A generated starknet-layout claim and its witness: the program of
    loop_claim run for `steps` VM steps (a power of two, at least 131072:
    below it the diluted pool's padding does not fit the trace), with
    builtin instances made up from fixed seeds so that each builtin's
    real-instance code runs: Pedersen and bitwise inputs below 2^251,
    Poseidon inputs below p, EC-op points that are multiples of the
    generator, ECDSA signatures by one seeded private key, and 128-bit
    range checks whose parts lie in the VM's [rc_min, rc_max].

    The builtin segments follow the execution segment, each sized by its
    ratio: pedersen (3 cells per 512 rows), range_check (1 per 256), ecdsa
    (2 per 32768), bitwise (5 per 1024), ec_op (7 per 16384), poseidon (6
    per 512), each stop_ptr past the instances it holds; the output
    segment is empty, at the pedersen segment's start.  At 131072 steps
    this is the size of the reference's bootloader proof (2^21 rows, 9 + 1
    columns, 195 constraints, LDE 2^22 at blowup 2).  Returns (claim,
    witness)."""
    registers, memory, pub = loop_run(steps, Layout.STARKNET)
    n = steps * StarknetAirConfig.CYCLE_HEIGHT
    base = max(max(e.address for e in pub.public_memory) + 2,
               int(registers.ap.max()) + 1)
    made = {
        "pedersen": _made_up_instances(pedersen, 1),
        "range_check": _made_up_rc128(range_check, 3, pub.rc_min,
                                      pub.rc_max),
        "ecdsa": _made_up_signatures(ecdsa, 4),
        "bitwise": _made_up_instances(bitwise, 2),
        "ec_op": _made_up_ec_ops(ec_op, 5),
        "poseidon": _made_up_poseidons(poseidon, 6),
    }
    # (cells an instance, rows an instance slot) of each builtin segment
    sizes = {"pedersen": (3, 512), "range_check": (1, 256),
             "ecdsa": (2, 32768), "bitwise": (5, 1024),
             "ec_op": (7, 16384), "poseidon": (6, 512)}
    pub.memory_segments["output"] = Segment(base, base)
    begin = base
    for name, (cells, rows) in sizes.items():
        pub.memory_segments[name] = Segment(
            begin, begin + cells * len(made[name]))
        begin += cells * (n // rows)
    witness = CairoWitness(
        air_private_input=AirPrivateInput("", "", *made.values()),
        register_states=registers, memory=memory)
    claim = CairoClaim(None, pub, device=device, layout=Layout.STARKNET,
                       scheme=scheme)
    return claim, witness
