"""The eth scheme end to end on the CPU: the port proves the tiny plain
claim byte-identical to tests/data/self_proof_eth.bin (the JAX package's,
tools/gen_self_transcript.py), replays its transcript to
self_transcript_eth.json, the JAX verifier accepts the port's proof, the
port's verifier accepts the pinned proof and rejects tampered ones and the
other schemes' proofs, and the Solidity coin draws as the JAX coin does.
The cairo scheme's tiny proof goes through the same device-grind code
path (its CPU twin) and still equals self_proof_cairo.bin.  Tolerance 0:
proof bytes, digests and draws are exact."""

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain twins run some 10^4 small ops over a 2^16-nonce grind
    batch; with every test process using all cores, the intra-op thread
    pools oversubscribe the CPU and such a batch runs over a hundred times
    slower.  One thread keeps it near its single-process time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pinned(scheme):
    with open(os.path.join(DATA, f"self_proof_{scheme}.bin"), "rb") as f:
        return f.read()


def _jax_pub():
    """The tiny claim's public input built by the JAX package."""
    from sandstorm_tpu.binary.formats import Layout as JaxLayout
    from sandstorm_tpu.runner.vm import (CairoVM, instr_assert_eq_imm,
                                         instr_jmp_rel_imm)
    vm = CairoVM([instr_assert_eq_imm(), 10, instr_jmp_rel_imm(), 0], P)
    trace, mem = vm.run(16, initial_ap=6, extra_memory={5: 0})
    return vm.build_public_input(trace, mem, layout=JaxLayout.PLAIN)


@pytest.fixture(scope="module")
def port_proof():
    claim, witness = loop_claim(16, CPU, scheme="eth")
    return serialize_proof(claim.prove(witness, OPTIONS))


def test_port_proof_equals_pinned_bytes(port_proof):
    assert port_proof == _pinned("eth")


def test_transcript_replay_equals_pinned(port_proof):
    from sandstorm_tpu_torch.stark.transcript_replay import replay_transcript
    claim, _ = loop_claim(16, CPU, scheme="eth")
    draws = replay_transcript(TF, claim.air_config, claim.public_input,
                              parse_proof(port_proof), claim.scheme)
    with open(os.path.join(DATA, "self_transcript_eth.json")) as f:
        assert draws == json.load(f)


def test_jax_verifier_accepts_port_proof(port_proof):
    from sandstorm_tpu.binary.formats import Layout as JaxLayout
    from sandstorm_tpu.claims import EthVerifierClaim as JaxEthClaim
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.stark.ark import parse_proof as jax_parse
    jax_claim = JaxEthClaim(None, _jax_pub(), field=JF,
                            layout=JaxLayout.PLAIN)
    assert jax_claim.verify(jax_parse(port_proof, modulus=P),
                            required_security_bits=0)


def test_port_verifier_accepts_pinned_and_rejects_tampered():
    from sandstorm_tpu_torch.claims import EthVerifierClaim
    base, _ = loop_claim(16, CPU)
    claim = EthVerifierClaim(None, base.public_input, device=CPU)
    blob = _pinned("eth")
    assert claim.verify(parse_proof(blob), required_security_bits=0)
    for pos in (len(blob) // 2, len(blob) - 5, 40):
        bad = bytearray(blob)
        bad[pos] ^= 0x01
        with pytest.raises((VerificationError, AssertionError)):
            claim.verify(parse_proof(bytes(bad)), required_security_bits=0)


@pytest.mark.parametrize("proof_scheme,claim_scheme",
                         [("eth", "cairo"), ("cairo", "eth"),
                          ("generic", "eth")])
def test_a_proof_of_one_scheme_fails_under_another(proof_scheme,
                                                   claim_scheme):
    claim, _ = loop_claim(16, CPU, scheme=claim_scheme)
    with pytest.raises((VerificationError, AssertionError)):
        claim.verify(parse_proof(_pinned(proof_scheme)),
                     required_security_bits=0)


def test_security_level_of_the_default_options():
    """65 queries at blowup 2 plus 16 PoW bits is 81 bits, capped at the
    20-byte masked Keccak digests' 80."""
    from sandstorm_tpu_torch.stark.scheme import get_scheme
    assert ProofOptions().security_level_bits(
        field_bits=P.bit_length(),
        collision_resistance_bits=get_scheme(
            "eth").COLLISION_RESISTANCE_BITS) == 80


def test_aux_seed_and_first_solidity_draws_match_jax():
    """The coin's seed (Keccak of the canonical aux-input stream), then the
    first felts, a one-at-a-time felt reseed, a vector reseed, queries (not
    batched by 4) and the PoW prefix and check, against the JAX coin."""
    from sandstorm_tpu.aux_input import CairoAuxInput as JaxAux
    from sandstorm_tpu.crypto.hashes import \
        CanonicalKeccak256HashFn as JaxCanon
    from sandstorm_tpu.stark.scheme import get_scheme as jax_scheme
    from sandstorm_tpu_torch.aux_input import CairoAuxInput
    from sandstorm_tpu_torch.crypto.hashes import CanonicalKeccak256HashFn
    from sandstorm_tpu_torch.stark.scheme import get_scheme
    claim, _ = loop_claim(16, CPU, scheme="eth")
    pub, jpub = claim.public_input, _jax_pub()
    assert CairoAuxInput(pub).serialize(CanonicalKeccak256HashFn) == \
        JaxAux(jpub).serialize(JaxCanon)
    ours = get_scheme("eth").make_coin(pub, OPTIONS, 256)
    ref = jax_scheme("eth").make_coin(jpub, OPTIONS, 256)
    assert ours.digest == ref.digest
    assert ours.draw_felts(P, 3) == ref.draw_felts(P, 3)
    for c in (ours, ref):
        c.reseed_with_field_elements(P, [3, 1 << 200, P - 1])
    assert ours.digest == ref.digest
    assert ours.draw_felt(1 << 64) == ref.draw_felt(1 << 64)
    for c in (ours, ref):
        c.reseed_with_field_element_vector(P, [7, P - 2])
    assert ours.digest == ref.digest
    assert ours.draw_queries(7, 1 << 12) == ref.draw_queries(7, 1 << 12)
    assert ours._pow_prefix(16) == ref._pow_prefix(16)
    nonce = ours.grind_proof_of_work(8, CPU)
    assert nonce == ref.grind_proof_of_work(8)
    assert ours.verify_proof_of_work(nonce, 8)
    assert all(not ours.verify_proof_of_work(k, 8) for k in range(1, nonce))


def test_solidity_coin_reference_vector():
    """The reference's draw vector (crypto/src/public_coin/solidity.rs,
    tests/test_crypto.py)."""
    from sandstorm_tpu_torch.crypto.coins import SolidityVerifierPublicCoin
    coin = SolidityVerifierPublicCoin(b"\x00" * 32)
    assert [coin.draw_felt(P) for _ in range(4)] == [
        914053382091189896561965228399096618375831658573140010954888220151670628653,
        3496720894051083870907112578962849417100085660158534559258626637026506475074,
        1568281537905787801632546124130153362941104398120976544423901633300198530772,
        539395842685339476048032152056539303790683868668644006005689195830492067187,
    ]


def test_cairo_proof_through_the_device_grind_path(monkeypatch):
    """The Cairo coin grinds through crypto/grind.py (on the CPU, its plain
    twin) once per prove, and the tiny cairo proof still equals
    self_proof_cairo.bin: the grind returns the host loop's nonce."""
    from sandstorm_tpu_torch.crypto import coins
    calls = []

    def counted(*args, **kwargs):
        calls.append((args, kwargs))
        return grind(*args, **kwargs)

    grind = coins.grind
    monkeypatch.setattr(coins, "grind", counted)
    claim, witness = loop_claim(16, CPU, scheme="cairo")
    proof = claim.prove(witness, OPTIONS)
    assert serialize_proof(proof) == _pinned("cairo")
    assert len(calls) == 1
    (hash_name, prefix, bits), kwargs = calls[0]
    assert (hash_name, bits, kwargs["device"]) == ("blake2s", 4, CPU)
    coin = coins.CairoVerifierPublicCoin(bytes(32))
    assert proof.pow_nonce == min(
        k for k in range(1, 1 << 12)
        if int.from_bytes(coin.HASH(prefix + k.to_bytes(8, "big"))[:4],
                          "big") >> 28 == 0)

