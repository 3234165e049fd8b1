"""The cairo scheme end to end on the CPU: the port proves the tiny plain
claim byte-identical to tests/data/self_proof_cairo.bin (which the JAX
package produced, tools/gen_self_transcript.py), replays its transcript to
self_transcript_cairo.json, the JAX verifier accepts the port's proof, and
the port's verifier accepts the pinned proof and rejects tampered ones."""

import json
import os

import pytest
import torch

from sandstorm_tpu_torch.claims import loop_claim
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.stark.ark import parse_proof, serialize_proof
from sandstorm_tpu_torch.stark.options import ProofOptions
from sandstorm_tpu_torch.stark.verifier import VerificationError

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = torch.device("cpu")
P = TF.MODULUS
OPTIONS = ProofOptions(num_queries=4, proof_of_work_bits=4)


def _pinned(scheme):
    with open(os.path.join(DATA, f"self_proof_{scheme}.bin"), "rb") as f:
        return f.read()


def _jax_pub():
    """The tiny claim's public input built by the JAX package (its layout
    enum is the JAX package's own, which its aux input compares against)."""
    from sandstorm_tpu.binary.formats import Layout as JaxLayout
    from sandstorm_tpu.runner.vm import (CairoVM, instr_assert_eq_imm,
                                         instr_jmp_rel_imm)
    vm = CairoVM([instr_assert_eq_imm(), 10, instr_jmp_rel_imm(), 0], P)
    trace, mem = vm.run(16, initial_ap=6, extra_memory={5: 0})
    return vm.build_public_input(trace, mem, layout=JaxLayout.PLAIN)


@pytest.fixture(scope="module")
def port_proof():
    claim, witness = loop_claim(16, CPU, scheme="cairo")
    return serialize_proof(claim.prove(witness, OPTIONS))


def test_port_proof_equals_pinned_bytes(port_proof):
    assert port_proof == _pinned("cairo")


def test_transcript_replay_equals_pinned(port_proof):
    from sandstorm_tpu_torch.stark.transcript_replay import replay_transcript
    claim, _ = loop_claim(16, CPU, scheme="cairo")
    draws = replay_transcript(TF, claim.air_config, claim.public_input,
                              parse_proof(port_proof), claim.scheme)
    with open(os.path.join(DATA, "self_transcript_cairo.json")) as f:
        assert draws == json.load(f)


def test_jax_verifier_accepts_port_proof(port_proof):
    from sandstorm_tpu.binary.formats import Layout as JaxLayout
    from sandstorm_tpu.claims import CairoClaim as JaxClaim
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.stark.ark import parse_proof as jax_parse
    jax_claim = JaxClaim(None, _jax_pub(), field=JF, layout=JaxLayout.PLAIN,
                         scheme="cairo")
    assert jax_claim.verify(jax_parse(port_proof, modulus=P),
                            required_security_bits=0)


def test_port_verifier_accepts_pinned_and_rejects_tampered():
    claim, _ = loop_claim(16, CPU, scheme="cairo")
    blob = _pinned("cairo")
    assert claim.verify(parse_proof(blob), required_security_bits=0)
    for pos in (len(blob) // 2, len(blob) - 5, 40):
        bad = bytearray(blob)
        bad[pos] ^= 0x01
        with pytest.raises((VerificationError, AssertionError)):
            claim.verify(parse_proof(bytes(bad)), required_security_bits=0)
    # the generic scheme's proof of the same claim is not a cairo proof
    with pytest.raises((VerificationError, AssertionError)):
        claim.verify(parse_proof(_pinned("generic")),
                     required_security_bits=0)


def test_security_level_of_the_default_options():
    """65 queries at blowup 2 plus 16 PoW bits is 81 bits, capped at the
    20-byte masked digests' 80: the default requirement of verify()."""
    from sandstorm_tpu_torch.stark.scheme import get_scheme
    scheme = get_scheme("cairo")
    assert ProofOptions().security_level_bits(
        field_bits=P.bit_length(),
        collision_resistance_bits=scheme.COLLISION_RESISTANCE_BITS) == 80


def test_aux_input_and_coin_seed_match_jax():
    """The public-input element stream the coin is seeded from."""
    from sandstorm_tpu.aux_input import CairoAuxInput as JaxAux
    from sandstorm_tpu.crypto.hashes import PedersenHashFn as JaxPedersen
    from sandstorm_tpu.stark.scheme import get_scheme as jax_scheme
    from sandstorm_tpu_torch.aux_input import CairoAuxInput
    from sandstorm_tpu_torch.crypto.hashes import PedersenHashFn
    from sandstorm_tpu_torch.stark.scheme import get_scheme
    claim, _ = loop_claim(16, CPU, scheme="cairo")
    pub, jpub = claim.public_input, _jax_pub()
    assert CairoAuxInput(pub).serialize(PedersenHashFn) == \
        JaxAux(jpub).serialize(JaxPedersen)
    ours = get_scheme("cairo").make_coin(pub, OPTIONS, 256)
    ref = jax_scheme("cairo").make_coin(jpub, OPTIONS, 256)
    assert ours.digest == ref.digest
