"""The reference verifier and its hashes against the program's, on the
card's pinned proofs (tests/data/) and the tiny CPU proofs: accepted as
they are, rejected once altered or asked for other options or another
program."""

import os

import pytest

from portbench.reference import hashes, pedersen
from portbench.reference import verify as reference
from portbench.reference.public_input import AirPublicInput, program_words
from portbench.tests.conftest import ROOT

DATA = ROOT / "tests" / "data"


@pytest.mark.parametrize("a, b", [
    (0, 0), (1, 0), (0, 1), (pedersen.P - 1, pedersen.P - 1),
    ((1 << 248) - 1, 1 << 248), (12345678901234567890, 98765432109876543210),
    (int.from_bytes(b"\x07" * 31, "big"), int.from_bytes(b"\x35" * 31, "big"))])
def test_pedersen_equals_the_oracle_and_the_program(a, b):
    from sandstorm_tpu_torch.builtins.pedersen import pedersen_hash
    got = pedersen.pedersen_hash(a, b)
    assert got == pedersen.pedersen_hash_oracle(a, b) == pedersen_hash(a, b)


@pytest.mark.parametrize("length", [0, 1, 31, 32, 64, 135, 136, 137, 288])
def test_keccak_equals_the_programs(length):
    from sandstorm_tpu_torch.crypto.hashes import keccak256
    msgs = [os.urandom(length) for _ in range(5)]
    want = [keccak256(m) for m in msgs]
    assert [hashes.keccak256(m) for m in msgs] == want
    assert hashes.keccak256_many(msgs) == want
    with pytest.raises(ValueError):
        hashes.keccak256_many([b"a", b"ab"])


def _bundle(tmp_path, claim, witness):
    from sandstorm_tpu_torch.fields.fp252 import Fp252
    from sandstorm_tpu_torch.tools.make_artifacts import (LOOP_PROGRAM,
                                                          write_bundle)
    paths = write_bundle(tmp_path, LOOP_PROGRAM, Fp252.MODULUS,
                         witness.register_states, witness.memory,
                         claim.public_input, witness.air_private_input)
    return (AirPublicInput.from_json(paths["public"]),
            program_words(paths["program"])[0])


def _options(blob):
    from portbench.reference.proof import parse_proof
    return dict(zip(reference.OPTION_NAMES, parse_proof(blob).options))


def _claim(which):
    from sandstorm_tpu_torch import claims
    if which == "starknet":
        return claims.starknet_loop_claim(1 << 17, "cpu"), "eth", \
            "starknet_proof_eth.bin"
    if which == "recursive":
        return claims.recursive_loop_claim(1 << 14, "cpu"), "cairo", \
            "recursive_proof_cairo.bin"
    scheme = which.split("-")[1]
    return claims.loop_claim(16, "cpu", scheme=scheme), scheme, \
        f"self_proof_{scheme}.bin"


@pytest.fixture(scope="module", params=["starknet", "recursive",
                                        "plain-eth", "plain-cairo"])
def pinned(request, tmp_path_factory):
    (claim, witness), scheme, name = _claim(request.param)
    pub, program = _bundle(tmp_path_factory.mktemp(request.param), claim,
                           witness)
    blob = (DATA / name).read_bytes()
    return pub, program, scheme, blob, _options(blob)


def test_the_pinned_proof_is_accepted(pinned):
    pub, program, scheme, blob, options = pinned
    bits = reference.security_bits(options)
    reference.verify(blob, pub, program, scheme, options, bits)


@pytest.mark.parametrize("where", [0.0, 0.01, 0.3, 0.5, 0.77, 0.999])
def test_an_altered_byte_is_rejected(pinned, where):
    pub, program, scheme, blob, options = pinned
    bad = bytearray(blob)
    bad[min(int(len(bad) * where), len(bad) - 1)] ^= 0x10
    with pytest.raises(reference.Rejected):
        reference.verify(bytes(bad), pub, program, scheme, options, 0)


def test_other_options_another_program_or_more_security_are_rejected(pinned):
    pub, program, scheme, blob, options = pinned
    with pytest.raises(reference.Rejected, match="options"):
        reference.verify(blob, pub, program, scheme,
                         {**options, "num_queries": options["num_queries"]
                          + 1}, 0)
    with pytest.raises(reference.Rejected, match="program"):
        reference.verify(blob, pub, [program[0], program[1] + 1]
                         + program[2:], scheme, options, 0)
    with pytest.raises(reference.Rejected, match="security"):
        reference.verify(blob, pub, program, scheme, options,
                         reference.security_bits(options) + 1)
    with pytest.raises(reference.Rejected):
        reference.verify(blob[:-7], pub, program, scheme, options, 0)
