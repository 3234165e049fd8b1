"""The whole slice on the CPU: the port proves the tiny plain/generic claim
byte-identical to tests/data/self_proof_generic.bin (which the JAX package
produced, tools/gen_self_transcript.py), the JAX verifier accepts the port's
proof, the port's verifier accepts the pinned proof and rejects a tampered
one, and the port's AIR and composition agree with the JAX package's."""

import os

import numpy as np
import pytest
import torch

from sandstorm_tpu_torch.binary.formats import (AirPrivateInput, CairoWitness,
                                                Layout)
from sandstorm_tpu_torch.claims import CairoClaim
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.runner.vm import (CairoVM, instr_assert_eq_imm,
                                           instr_jmp_rel_imm)
from sandstorm_tpu_torch.stark.ark import parse_proof, serialize_proof
from sandstorm_tpu_torch.stark.options import ProofOptions
from sandstorm_tpu_torch.stark.verifier import VerificationError

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = torch.device("cpu")
P = TF.MODULUS
OPTIONS = ProofOptions(num_queries=4, proof_of_work_bits=4)


def _tiny_claim(scheme):
    vm = CairoVM([instr_assert_eq_imm(), 10, instr_jmp_rel_imm(), 0], P)
    trace, mem = vm.run(16, initial_ap=6, extra_memory={5: 0})
    registers, memory = vm.to_witness_arrays(trace, mem)
    pub = vm.build_public_input(trace, mem, layout=Layout.PLAIN)
    witness = CairoWitness(
        air_private_input=AirPrivateInput("", "", [], [], [], [], [], []),
        register_states=registers, memory=memory)
    return CairoClaim(None, pub, device=CPU, layout=Layout.PLAIN,
                      scheme=scheme), witness, pub


def _pinned():
    with open(os.path.join(DATA, "self_proof_generic.bin"), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def port_proof():
    claim, witness, _ = _tiny_claim("generic")
    return serialize_proof(claim.prove(witness, OPTIONS))


def test_port_proof_equals_pinned_bytes(port_proof):
    assert port_proof == _pinned()


def test_jax_verifier_accepts_port_proof(port_proof):
    from sandstorm_tpu.binary.formats import Layout as JaxLayout
    from sandstorm_tpu.claims import CairoClaim as JaxClaim
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.stark.ark import parse_proof as jax_parse
    _, _, pub = _tiny_claim("generic")
    claim = JaxClaim(None, pub, field=JF, layout=JaxLayout.PLAIN,
                     scheme="generic")
    assert claim.verify(jax_parse(port_proof, modulus=P),
                        required_security_bits=0)


def test_port_verifier_accepts_pinned_and_rejects_tampered():
    claim, _, _ = _tiny_claim("generic")
    blob = _pinned()
    assert claim.verify(parse_proof(blob), required_security_bits=0)
    for pos in (len(blob) // 2, len(blob) - 5, 40):
        bad = bytearray(blob)
        bad[pos] ^= 0x01
        with pytest.raises((VerificationError, AssertionError)):
            claim.verify(parse_proof(bytes(bad)), required_security_bits=0)


def test_loop_claim_is_the_pinned_claim():
    """The port's generated claim (what chip_smoke.py proves) at 16 steps is
    the claim of the pinned proof."""
    from sandstorm_tpu_torch.claims import loop_claim
    claim, witness = loop_claim(16, CPU)
    _, want_witness, want_pub = _tiny_claim("generic")
    assert claim.public_input == want_pub
    assert np.array_equal(witness.register_states.arr,
                          want_witness.register_states.arr)
    assert np.array_equal(witness.memory.values, want_witness.memory.values)
    assert np.array_equal(witness.memory.known, want_witness.memory.known)


def test_other_layouts_and_schemes_are_not_ported():
    _, _, pub = _tiny_claim("generic")
    with pytest.raises(NotImplementedError):
        CairoClaim(None, pub, device=CPU, layout=Layout.STARKNET)
    with pytest.raises(NotImplementedError):
        CairoClaim(None, pub, device=CPU, layout=Layout.PLAIN, scheme="eth")


def test_air_dag_matches_jax():
    """The AIR's parameters: the port's plain constraint DAG walks to the
    same node sequence (keys, hence constants) as the JAX package's, and
    gives the same trace arguments and hints."""
    from sandstorm_tpu.air.expr import trace_arguments as jax_targs
    from sandstorm_tpu.air.expr import walk as jax_walk
    from sandstorm_tpu.layouts.plain.air import PlainAirConfig as JaxAir
    from sandstorm_tpu_torch.air.expr import trace_arguments, walk
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    n = 256
    g = TF.root_of_unity_int(n)
    port = PlainAirConfig.constraints(n, P, g)
    ref = JaxAir.constraints(n, P, g)
    assert [x.key for x in walk(port)] == [x.key for x in jax_walk(ref)]
    assert trace_arguments(port) == jax_targs(ref)
    _, _, pub = _tiny_claim("generic")
    ch = [12345, 678910, 111213]
    assert PlainAirConfig.gen_hints(n, pub, ch, P) == \
        JaxAir.gen_hints(n, pub, ch, P)


def test_trace_columns_match_jax():
    """Host trace build and the one-copy upload against the JAX package's
    trace (canonical numpy columns, Montgomery device columns)."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.layouts.plain.trace import PlainExecutionTrace as JT
    from sandstorm_tpu_torch.interop import to_jax_digits
    from sandstorm_tpu_torch.layouts.plain.trace import PlainExecutionTrace
    _, witness, pub = _tiny_claim("generic")
    port = PlainExecutionTrace(TF, None, pub, witness, CPU)
    ref = JT(JF, None, pub, witness)
    assert port.trace_len == ref.trace_len
    for c, col in ref.base_cols_canonical.items():
        assert np.array_equal(port.base_cols_canonical[c], col)
    want = JF.encode_canonical_u64_many(
        [ref.base_cols_canonical[c] for c in sorted(ref.base_cols_canonical)])
    got = port.base_columns()
    for c, w in zip(sorted(got), want):
        assert np.array_equal(to_jax_digits(got[c]), np.asarray(w))


def test_composition_matches_host_evaluation():
    """The folded composition over the LDE domain, at sampled domain points,
    equals the constraints evaluated there with python ints (evaluate_int)
    from the same LDE rows."""
    from sandstorm_tpu_torch.air.expr import (IntContext, LdeContext,
                                              evaluate_int, evaluate_lde,
                                              trace_arguments)
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.stark.prover import _DomainCache, _lde_and_coeffs
    claim, witness, pub = _tiny_claim("generic")
    trace = claim.generate_trace(witness)
    n, blowup, coset = trace.trace_len, 2, TF.GENERATOR
    N = n * blowup
    ch = [31337, 4242, 777]
    cols = {**trace.base_columns(), **trace.build_extension_columns(ch)}
    _, lde = _lde_and_coeffs(TF, cols, blowup, coset)
    g = TF.root_of_unity_int(n)
    cons = PlainAirConfig.constraints(n, P, g)
    hints = PlainAirConfig.gen_hints(n, pub, ch, P)
    dom = _DomainCache(TF, N, coset, CPU)
    alpha = 987654321
    ctx = LdeContext(TF, lde, blowup, dom.domain, dom.x_pow,
                     challenges=[TF.encode_int(c, CPU) for c in ch],
                     hints=[TF.encode_int(h, CPU) for h in hints])

    def fold(acc, v, i):
        t = TF.mul(v, TF.encode_int(pow(alpha, i, P), CPU))
        return t if acc is None else TF.add(acc, t)

    comp = TF.decode_ints(evaluate_lde(cons, ctx, N, fold=fold))
    vals = {c: TF.decode_ints(v) for c, v in lde.items()}
    w = TF.root_of_unity_int(N)
    for i in (0, 1, 77, N - 1):
        x = coset * pow(w, i, P) % P
        tv = {(c, off): vals[c][(i + off * blowup) % N]
              for (c, off) in trace_arguments(cons)}
        cv = evaluate_int(cons, IntContext(P, x, tv, ch, hints))
        assert comp[i] == sum(v * pow(alpha, k, P)
                              for k, v in enumerate(cv)) % P


@pytest.mark.slow
def test_composition_matches_jax_evaluate_lde():
    """The port's composition values equal the JAX evaluate_lde's on the
    same LDE columns (slow: XLA:CPU compiles every node's shape)."""
    import jax.numpy as jnp
    from sandstorm_tpu.air.expr import LdeContext as JaxCtx
    from sandstorm_tpu.air.expr import evaluate_lde as jax_eval
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.layouts.plain.air import PlainAirConfig as JaxAir
    from sandstorm_tpu.stark.prover import _DomainCache as JaxDom
    from sandstorm_tpu_torch.air.expr import LdeContext, evaluate_lde
    from sandstorm_tpu_torch.interop import to_jax_digits
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.stark.prover import _DomainCache, _lde_and_coeffs
    claim, witness, pub = _tiny_claim("generic")
    trace = claim.generate_trace(witness)
    n, blowup, coset = trace.trace_len, 2, TF.GENERATOR
    N = n * blowup
    ch = [31337, 4242, 777]
    cols = {**trace.base_columns(), **trace.build_extension_columns(ch)}
    _, lde = _lde_and_coeffs(TF, cols, blowup, coset)
    cons = PlainAirConfig.constraints(n, P, TF.root_of_unity_int(n))
    hints = PlainAirConfig.gen_hints(n, pub, ch, P)
    dom = _DomainCache(TF, N, coset, CPU)
    got = evaluate_lde(cons, LdeContext(
        TF, lde, blowup, dom.domain, dom.x_pow,
        challenges=[TF.encode_int(c, CPU) for c in ch],
        hints=[TF.encode_int(h, CPU) for h in hints]), N)
    jdom = JaxDom(JF, N, coset)
    want = jax_eval(
        JaxAir.constraints(n, P, TF.root_of_unity_int(n)),
        JaxCtx(JF, {c: jnp.asarray(to_jax_digits(v)) for c, v in lde.items()},
               blowup, jdom.domain, jdom.x_pow,
               challenges=[JF.encode_int(c) for c in ch],
               hints=[JF.encode_int(h) for h in hints], coset=coset), N)
    assert len(want) == len(got) == 47
    for g_, w_ in zip(got, want):
        assert np.array_equal(to_jax_digits(g_), np.asarray(w_))


def test_check_air_tool_finds_the_plain_constraints_dividing_out(capsys):
    """tools/check_air.py on the tiny plain claim, on the CPU: every
    constraint group divides out."""
    from sandstorm_tpu_torch.tools import check_air
    assert check_air.main(["plain", "--steps", "16", "--device", "cpu"]) == 0
    assert "all 47 plain constraints divide out" in capsys.readouterr().out
