"""The cairo scheme over Goldilocks on the CPU, against the JAX package: the
Cairo coin's draws over GL, the friendly-tree commitment of GL columns
(rows read as Stark252 felts, Pedersen merges in the 252-bit field), the
tiny proof == tests/data/self_proof_cairo_gl.bin (the JAX package's proof,
sha256 TINY_SHA256["goldilocks_cairo"] in chip_smoke.py) with its
transcript, both verifiers on it, and the card's proof of
plain-cairo-gl-2^16 (tests/data/plain_cairo_gl_proof.bin, sha256
SLICE_SHA256["slice_cairo_gl"]) accepted by both verifiers at 64 bits, the
Goldilocks field's cap."""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from chip_smoke import SLICE_SHA256, STEPS, TINY_SHA256
from sandstorm_tpu_torch.claims import CairoVerifierClaim, loop_claim
from sandstorm_tpu_torch.crypto.coins import CairoVerifierPublicCoin
from sandstorm_tpu_torch.crypto.hashes import to_montgomery_bytes
from sandstorm_tpu_torch.fields.goldilocks import GL
from sandstorm_tpu_torch.stark.ark import parse_proof, serialize_proof
from sandstorm_tpu_torch.stark.options import ProofOptions
from sandstorm_tpu_torch.stark.scheme import CairoVerifierScheme
from sandstorm_tpu_torch.stark.verifier import VerificationError

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = torch.device("cpu")
P = GL.MODULUS
OPTIONS = ProofOptions(num_queries=4, proof_of_work_bits=4)


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _jax_claim(pub):
    """The JAX package's cairo claim over GL of the port's public input
    (its layout enum is the JAX package's own, which the aux input reads)."""
    from sandstorm_tpu.binary.formats import Layout as JaxLayout
    from sandstorm_tpu.claims import CairoClaim as JaxClaim
    from sandstorm_tpu.fields.goldilocks import GL as JGL
    return JaxClaim(None, dataclasses.replace(pub, layout=JaxLayout.PLAIN),
                    field=JGL, layout=JaxLayout.PLAIN, scheme="cairo")


@pytest.fixture(scope="module")
def tiny():
    """(claim, the port's tiny proof) on the CPU."""
    claim, witness = loop_claim(16, CPU, field=GL, scheme="cairo")
    return claim, serialize_proof(claim.prove(witness, OPTIONS))


# -- the coin -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coin_draws_over_gl_equal_jax(seed):
    """draw_felt / draw_felts / draw_queries asked for GL.MODULUS give the
    JAX coin's sequence: Stark252 felts, not reduced by the coin (the engine
    reduces them), after reseeds with a digest and with GL elements."""
    from sandstorm_tpu.crypto.coins import CairoVerifierPublicCoin as JaxCoin
    digest = hashlib.sha256(bytes([seed])).digest()
    ours, ref = CairoVerifierPublicCoin(digest), JaxCoin(digest)
    draws = []
    for coin in (ours, ref):
        coin.reseed_with_digest(hashlib.sha256(digest).digest())
        out = [coin.draw_felt(P)] + coin.draw_felts(P, 5)
        coin.reseed_with_field_element_vector(P, [0, 1, P - 1, out[0] % P])
        out += coin.draw_felts(P, 3) + coin.draw_queries(65, 1 << 21)
        draws.append(out)
    assert draws[0] == draws[1]
    assert any(v >= P for v in draws[0][:9]), "no draw exceeds p"


# -- the commitment -----------------------------------------------------------

def test_gl_values_read_as_stark252_felts():
    """A GL value's row-hash words are to_montgomery_bytes of the value
    (v * 2^256 mod P252, big-endian); its tree felt is the value itself."""
    from sandstorm_tpu_torch.fields.fp252 import Fp252
    vals = [0, 1, 2, P - 1, P - 2, (1 << 32) + 5, 0xDEADBEEFCAFEBABE % P]
    a = GL.encode_ints(vals, CPU)
    words = GL.to_stark252_mont_be_words(a).numpy().astype("<u4")
    assert [w.tobytes() for w in words] == [to_montgomery_bytes(v)
                                            for v in vals]
    assert Fp252.decode_np(GL.to_stark252_canonical(a).numpy()).tolist() \
        == vals


@pytest.mark.parametrize("ncols,log_n", [(1, 10), (2, 11), (5, 12), (8, 10)])
def test_gl_commit_equals_jax_host_tree(ncols, log_n):
    """The scheme's commit of GL columns (levels of 2^9 pairs and more
    through the walk's plain version, the rest through the host batch)
    against the JAX package's FriendlyMerkleTree.from_rows(22, rows): root,
    paths, and the scheme's verify_row on them."""
    from sandstorm_tpu.crypto.merkle_variants import FriendlyMerkleTree as JT
    n = 1 << log_n
    rng = np.random.default_rng(100 * ncols + log_n)
    vals = rng.integers(0, P, size=(ncols, n), dtype=np.uint64)
    vals[0, 0], vals[-1, 1] = 0, P - 1
    cols = [GL.encode_ints([int(v) for v in c], CPU) for c in vals]
    rows = [[int(v) for v in r] for r in vals.T]
    scheme = CairoVerifierScheme()
    tree = scheme.commit(GL, cols)
    assert len(tree._felt_dev) > 1, "the walk's route was not taken"
    ref = JT.from_rows(22, rows)

    def wire(node):
        return node[1] if isinstance(node[1], bytes) \
            else int(node[1]).to_bytes(32, "big")

    assert tree.root == wire(ref.root)
    idx = [0, 1, 7, n // 2 + 3, n - 1]
    paths = tree.prove_batch(idx)
    assert paths == [[wire(x) for x in ref.prove(i)] for i in idx]
    for i, path in zip(idx, paths):
        assert scheme.verify_row(GL, tree.root, i, rows[i], path)
    assert not scheme.verify_row(GL, tree.root, 1, rows[0], paths[1])


# -- the tiny proof -----------------------------------------------------------

def test_tiny_proof_equals_the_jax_proof(tiny):
    blob = tiny[1]
    assert blob == _read("self_proof_cairo_gl.bin")
    assert len(blob) == 11449
    assert hashlib.sha256(blob).hexdigest() == TINY_SHA256["goldilocks_cairo"]


def test_tiny_transcript_equals_jax_replay(tiny):
    """The port's replay of the proof's Fiat-Shamir draws equals the JAX
    package's; the drawn felts exceed p, so each is reduced where it enters
    a GL tensor."""
    from sandstorm_tpu.stark.ark import parse_proof as jax_parse
    from sandstorm_tpu.stark.transcript_replay import (
        replay_transcript as jax_replay)
    from sandstorm_tpu_torch.stark.transcript_replay import replay_transcript
    claim, blob = tiny
    ours = replay_transcript(GL, claim.air_config, claim.public_input,
                             parse_proof(blob, modulus=P), claim.scheme)
    jc = _jax_claim(claim.public_input)
    ref = jax_replay(jc.F, jc.air_config, jc.public_input,
                     jax_parse(blob, modulus=P), jc.scheme)
    assert ours == ref
    felts = ours["challenges"] + [ours["z"], ours["alpha_comp"],
                                  ours["alpha_deep"]] + ours["betas"]
    assert all(v >= P for v in felts)


def test_both_verifiers_accept_the_tiny_proof_and_reject_tampered(tiny):
    from sandstorm_tpu.stark.ark import parse_proof as jax_parse
    claim, blob = tiny
    jc = _jax_claim(claim.public_input)
    assert claim.verify(parse_proof(blob, modulus=P),
                        required_security_bits=0)
    assert jc.verify(jax_parse(blob, modulus=P), required_security_bits=0)
    for pos in (len(blob) // 2, len(blob) - 5, 40):
        bad = bytearray(blob)
        bad[pos] ^= 0x01
        with pytest.raises((VerificationError, AssertionError)):
            claim.verify(parse_proof(bytes(bad), modulus=P),
                         required_security_bits=0)
        with pytest.raises(Exception):
            assert jc.verify(jax_parse(bytes(bad), modulus=P),
                             required_security_bits=0)


def test_claim_api_entry_point():
    """CairoVerifierClaim takes field=GL (no CLI route reaches it)."""
    claim, _ = loop_claim(16, CPU)
    gl = CairoVerifierClaim(None, claim.public_input, device=CPU, field=GL)
    assert (gl.F, gl.scheme.name) == (GL, "cairo")


# -- the card's proof of plain-cairo-gl-2^16 ----------------------------------

@pytest.fixture(scope="module")
def card():
    """(claim of plain-cairo-gl-2^16 on the CPU, the card's proof)."""
    claim, _ = loop_claim(STEPS, CPU, field=GL, scheme="cairo")
    return claim, _read("plain_cairo_gl_proof.bin")


def test_card_proof_is_the_digest_chip_smoke_pins(card):
    assert hashlib.sha256(card[1]).hexdigest() == \
        SLICE_SHA256["slice_cairo_gl"]


def test_port_verifier_accepts_the_card_proof_at_64_bits(card):
    """Accepted at 64 bits (the options' 81 bits capped by GL's 64-bit
    field), refused at 80 and rejected with one byte flipped."""
    claim, blob = card
    proof = parse_proof(blob, modulus=P)
    assert proof.trace_len == STEPS * 16
    assert claim.verify(proof, required_security_bits=64)
    with pytest.raises(VerificationError, match="security level"):
        claim.verify(proof, required_security_bits=80)
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x01
    with pytest.raises((VerificationError, AssertionError)):
        claim.verify(parse_proof(bytes(bad), modulus=P),
                     required_security_bits=64)


def test_jax_verifier_accepts_the_card_proof(card):
    from sandstorm_tpu.stark.ark import parse_proof as jax_parse
    claim, blob = card
    assert _jax_claim(claim.public_input).verify(
        jax_parse(blob, modulus=P), required_security_bits=64)
