"""The Goldilocks / GF(p^3) slice on the CPU: the port proves the tiny
plain-layout claim over GL and with GL3 challenges (generic scheme, 16
steps, 4 queries, 4 PoW bits) to the bytes the JAX package proves, pinned
by sha256 in chip_smoke.py (the same claim over GL under the cairo scheme:
tests/test_torch_cairo_gl.py, and the live JAX prove below); the JAX
verifier accepts the port's proofs;
the port's verifier accepts them and rejects tampered ones.  Also the three
host-side repairs that only a GF(p^3) run shows: the opener's point
powers, the generic row hash and the parse modulus.

The JAX package proves the GL3 claim in about 16 minutes on this CPU (most
of it XLA compile time on chained GL3 multiplies), so the live comparison
with it is the `slow` test at the end.
"""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TINY_SHA256
from sandstorm_tpu_torch.claims import CairoClaim, loop_claim
from sandstorm_tpu_torch.fields.gl3 import GL3, Fq3S, Q
from sandstorm_tpu_torch.fields.goldilocks import GL
from sandstorm_tpu_torch.stark.ark import parse_proof, serialize_proof
from sandstorm_tpu_torch.stark.options import ProofOptions
from sandstorm_tpu_torch.stark.verifier import VerificationError

CPU = torch.device("cpu")
OPTIONS = ProofOptions(num_queries=4, proof_of_work_bits=4)
FIELDS = {"goldilocks": GL, "gl3": GL3, "goldilocks_cairo": GL}
SCHEMES = {"goldilocks_cairo": "cairo"}
_PROOFS = {}


def _proof(name):
    """The port's tiny proof in field `name` (made once per process)."""
    if name not in _PROOFS:
        claim, witness = loop_claim(16, CPU, field=FIELDS[name],
                                    scheme=SCHEMES.get(name, "generic"))
        _PROOFS[name] = serialize_proof(claim.prove(witness, OPTIONS))
    return _PROOFS[name]


def _jax_claim(name, pub=None):
    """The JAX package's claim in field `name` (by default on the port's
    public input of the tiny claim)."""
    from sandstorm_tpu.binary.formats import Layout as JaxLayout
    from sandstorm_tpu.claims import CairoClaim as JaxClaim
    from sandstorm_tpu.fields.gl3 import GL3 as JG3
    from sandstorm_tpu.fields.goldilocks import GL as JGL
    if pub is None:
        pub = loop_claim(16, CPU)[0].public_input
    return JaxClaim(None, pub, field={"goldilocks": JGL, "gl3": JG3,
                                      "goldilocks_cairo": JGL}[name],
                    layout=JaxLayout.PLAIN, scheme=SCHEMES.get(name))


# -- the three repairs --------------------------------------------------------

def test_gl3_open_columns_matches_jax():
    """Repair 1: the opener's hi table starts from pt^b, a power of the
    host scalar F.s(pt); the integer pow(pt, b, p^3) of the packed int is
    another number.  The port's GL3 openings equal the JAX package's (its
    dense opener) on the same coefficients."""
    from sandstorm_tpu.fields.gl3 import GL3 as JG3
    from sandstorm_tpu.stark.openings import open_columns as jax_open
    from sandstorm_tpu_torch.stark.openings import open_columns
    rng = random.Random(5)
    n = 16
    cols = {c: GL3.encode_ints([rng.randrange(Q) for _ in range(n)], CPU)
            for c in (0, 1, 2)}
    targs = [(0, 0), (0, 1), (1, 0), (2, 3)]
    z = rng.randrange(Q)
    g = GL.root_of_unity_int(n)
    extra = [int(Fq3S.from_packed(z) ** 2)]
    got = open_columns(GL3, cols, targs, z, g, n, extra_points=extra,
                       extra_cols=[[1, 2]])
    want = jax_open(JG3, {c: jnp.asarray(v.numpy().view(np.uint32))
                          for c, v in cols.items()},
                    targs, z, g, n, extra_points=extra, extra_cols=[[1, 2]])
    # the dense JAX opener returns every column at every point: compare the
    # pairs asked for
    assert got[0] == {k: int(want[0][k]) for k in targs}
    assert got[1] == [{c: int(want[1][0][c]) for c in (1, 2)}]
    # and the values are the polynomials at the points
    zs = Fq3S.from_packed(z)
    coeffs = GL3.decode_ints(cols[2])
    pt = zs * pow(g, 3, GL.MODULUS)
    assert got[0][(2, 3)] == int(sum((pt ** i) * Fq3S.from_packed(c)
                                     for i, c in enumerate(coeffs)))


def test_gl3_row_hash_matches_jax():
    """Repair 2: a GF(p^3) element hashes as three 8-byte LE coordinates
    (GL3.to_hash_bytes_int), not as the packed int's own bytes."""
    from sandstorm_tpu.fields.gl3 import GL3 as JG3
    from sandstorm_tpu.stark.scheme import GenericScheme as JaxScheme
    from sandstorm_tpu_torch.merkle import MerkleTree
    from sandstorm_tpu_torch.stark.scheme import GenericScheme
    rng = random.Random(6)
    row = [rng.randrange(Q) for _ in range(5)] + [7, GL.MODULUS - 1]
    assert GenericScheme().hash_row(GL3, row) == \
        JaxScheme().hash_row(JG3, row)
    # the host mirror of the device leaf hash of the same row
    words = GL3.to_bytes_words(GL3.encode_ints(row, CPU)).reshape(1, -1)
    leaf = MerkleTree.from_matrix_columns([words])
    assert leaf.root == GenericScheme().hash_row(GL3, row)
    from sandstorm_tpu.fields.goldilocks import GL as JGL
    assert GenericScheme().hash_row(GL, row[5:]) == \
        JaxScheme().hash_row(JGL, row[5:]) == hashlib.blake2s(
            b"".join(v.to_bytes(8, "little") for v in row[5:]),
            digest_size=32).digest()


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_parse_proof_takes_the_field_modulus(name):
    """Repair 3: proofs parse against F.MODULUS (p or p^3).  The round
    trip holds, and a felt at the modulus is refused at parse time, which
    the 252-bit default would let through."""
    F = FIELDS[name]
    blob = _proof(name)
    assert serialize_proof(parse_proof(blob, modulus=F.MODULUS)) == blob
    bad = bytearray(blob)
    bad[-32:] = F.MODULUS.to_bytes(32, "little")   # the last OODS value
    parse_proof(bytes(bad))                        # 252-bit range: accepted
    with pytest.raises(AssertionError, match="non-canonical felt"):
        parse_proof(bytes(bad), modulus=F.MODULUS)


# -- the tiny proofs ----------------------------------------------------------

@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_tiny_proof_equals_the_jax_digest(name):
    blob = _proof(name)
    assert len(blob) == 11449
    assert hashlib.sha256(blob).hexdigest() == TINY_SHA256[name]


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_jax_verifier_accepts_port_proof(name):
    from sandstorm_tpu.stark.ark import parse_proof as jax_parse
    F = FIELDS[name]
    assert _jax_claim(name).verify(jax_parse(_proof(name), modulus=F.MODULUS),
                                   required_security_bits=0)


@pytest.mark.parametrize("name", ["goldilocks", "gl3"])
def test_port_verifier_accepts_and_rejects_tampered(name):
    F = FIELDS[name]
    claim, _ = loop_claim(16, CPU, field=F)
    blob = _proof(name)
    assert claim.verify(parse_proof(blob, modulus=F.MODULUS),
                        required_security_bits=0)
    for pos in (len(blob) // 2, len(blob) - 5, 40):
        bad = bytearray(blob)
        bad[pos] ^= 0x01
        with pytest.raises((VerificationError, AssertionError)):
            claim.verify(parse_proof(bytes(bad), modulus=F.MODULUS),
                         required_security_bits=0)


@pytest.mark.parametrize("name,scheme", [("goldilocks", "eth"),
                                         ("gl3", "eth"), ("gl3", "cairo")])
def test_gl3_security_and_scheme_limits(name, scheme):
    """GL3's 192 field bits leave the default options at 81 bits; GL's 64
    cap them, so a GL proof at the default options verifies at 64 bits.
    The eth scheme stays in the 252-bit field, and the cairo scheme takes
    GL but not GL3: the JAX package's own runs of these three fail."""
    opts = ProofOptions()
    assert opts.security_level_bits(GL3.MODULUS.bit_length(), 128) == 81
    assert opts.security_level_bits(GL.MODULUS.bit_length(), 128) == 64
    claim, _ = loop_claim(16, CPU)
    with pytest.raises(NotImplementedError):
        CairoClaim(None, claim.public_input, device=CPU, field=FIELDS[name],
                   scheme=scheme)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["goldilocks", "gl3", "goldilocks_cairo"])
def test_port_proof_equals_a_live_jax_proof(name):
    """The JAX package proves the same claim live (GL3: minutes of XLA
    compile time on the CPU) to the port's bytes."""
    from sandstorm_tpu.binary.formats import (AirPrivateInput, CairoWitness,
                                              Layout)
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.runner.vm import (CairoVM, instr_assert_eq_imm,
                                         instr_jmp_rel_imm)
    from sandstorm_tpu.stark.ark import serialize_proof as jax_serialize
    from sandstorm_tpu.stark.options import ProofOptions as JaxOptions
    vm = CairoVM([instr_assert_eq_imm(), 10, instr_jmp_rel_imm(), 0],
                 JF.MODULUS)
    trace, mem = vm.run(16, initial_ap=6, extra_memory={5: 0})
    registers, memory = vm.to_witness_arrays(trace, mem)
    pub = vm.build_public_input(trace, mem, layout=Layout.PLAIN)
    # the JAX package's own run of the port's claim (the transcript seed
    # serialises the public input)
    from sandstorm_tpu.stark.transcript import serialize_public_input as js
    from sandstorm_tpu_torch.stark.transcript import serialize_public_input
    assert js(pub) == serialize_public_input(loop_claim(16, CPU)[0]
                                             .public_input)
    witness = CairoWitness(
        air_private_input=AirPrivateInput("", "", [], [], [], [], [], []),
        register_states=registers, memory=memory)
    proof = _jax_claim(name, pub).prove(
        witness, JaxOptions(num_queries=4, proof_of_work_bits=4))
    assert jax_serialize(proof) == _proof(name)
