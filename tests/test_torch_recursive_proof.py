"""The card's proof of the recursive stand-in
(claims.recursive_loop_claim(16384), cairo scheme, default options),
tests/data/recursive_proof_cairo.bin, on the CPU: its sha256 is the one
chip_smoke.py pins, and the port's and the JAX package's verifiers accept
it at 80 bits (the port's rejects it with one byte flipped).  The JAX
package's own prove of the claim gives the same bytes: a `slow` test, some
two and a half hours of CPU prove (the smallest recursive trace has 2^18
rows)."""

import dataclasses
import hashlib
import importlib.util
import os

import pytest
import torch

from sandstorm_tpu_torch.claims import recursive_loop_claim
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF

CPU = torch.device("cpu")
P = TF.MODULUS
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def stand_in():
    return recursive_loop_claim(16384, CPU)


def _pinned_recursive():
    """The card's proof of the stand-in (chip_smoke.py phase 8, written by
    tools/profile_prove.py --layout recursive --scheme cairo --proof-out;
    the JAX package's prove gives the same bytes) and the sha256
    chip_smoke pins for it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(ROOT, "tests", "data",
                           "recursive_proof_cairo.bin"), "rb") as f:
        return f.read(), smoke.RECURSIVE_SHA256


def test_pinned_recursive_proof_is_the_digest_chip_smoke_pins():
    blob, digest = _pinned_recursive()
    assert hashlib.sha256(blob).hexdigest() == digest


def test_port_verifier_accepts_the_recursive_proof_and_rejects_tampered(
        stand_in):
    """The port's verifier, on the CPU, accepts the card's proof of the
    stand-in at 80 bits and rejects it with one byte flipped."""
    from sandstorm_tpu_torch.stark.ark import parse_proof
    from sandstorm_tpu_torch.stark.verifier import VerificationError
    claim = stand_in[0]
    blob, _ = _pinned_recursive()
    assert claim.verify(parse_proof(blob), required_security_bits=80)
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x01
    with pytest.raises((VerificationError, AssertionError)):
        claim.verify(parse_proof(bytes(bad)), required_security_bits=80)


def _jax_claim(claim):
    """The JAX package's claim of the same public input (which names the
    JAX package's Layout)."""
    from sandstorm_tpu.binary.formats import Layout as JaxLayout
    from sandstorm_tpu.claims import CairoClaim as JaxClaim
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    pub = dataclasses.replace(claim.public_input, layout=JaxLayout.RECURSIVE)
    return JaxClaim(None, pub, field=JF, layout=JaxLayout.RECURSIVE,
                    scheme="cairo")


def test_jax_verifier_accepts_the_port_recursive_proof(stand_in):
    """The JAX package's verifier accepts the port's proof of the stand-in
    at 80 bits."""
    from sandstorm_tpu.stark.ark import parse_proof as jax_parse
    blob, _ = _pinned_recursive()
    assert _jax_claim(stand_in[0]).verify(jax_parse(blob, modulus=P),
                                          required_security_bits=80)


@pytest.mark.slow
def test_jax_package_proves_the_pinned_bytes(stand_in):
    """The JAX package's prove of the stand-in on the CPU (default
    ProofOptions) is the pinned proof, byte for byte."""
    from sandstorm_tpu.stark.ark import serialize_proof
    from sandstorm_tpu.stark.options import ProofOptions
    claim, witness = stand_in
    blob = serialize_proof(_jax_claim(claim).prove(witness, ProofOptions()))
    assert blob == _pinned_recursive()[0]
