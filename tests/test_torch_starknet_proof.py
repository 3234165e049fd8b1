"""The starknet stand-in (claims.starknet_loop_claim(131072): 2^21 rows, the
eth scheme, default options) on the CPU: its 9 base columns, rc bounds and
uploads against the JAX package's StarknetExecutionTrace of the same
public input and witness, its made-up builtin instances, and the card's
proof of it, tests/data/starknet_proof_eth.bin: its sha256 is the one
chip_smoke.py pins, the port's verifier accepts it at 80 bits and rejects
it with one byte flipped, and the JAX package's verifier accepts it.  No
CPU prove of the claim is made: at 2^21 rows and 195 constraints it would
take days.  Every comparison is exact."""

import dataclasses
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from sandstorm_tpu_torch.claims import starknet_loop_claim
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.interop import to_jax_digits

CPU = torch.device("cpu")
P = TF.MODULUS
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stand_in():
    return starknet_loop_claim(1 << 17, CPU)


def test_stand_in_columns_match_jax(stand_in):
    """The nine base columns of the 131072-step stand-in and rc_min /
    rc_max equal the JAX package's trace of the same public input and
    witness; the upload (upload_base_columns, which base_columns runs)
    equals the JAX package's host Montgomery encoding on the first 2^14
    rows and 2^14 rows drawn from a seed (on the CPU the upload of 2^21 x 9
    elements takes most of a minute, the JAX encoding of as many python
    ints minutes)."""
    from sandstorm_tpu_torch.layouts.utils import upload_base_columns
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.layouts.starknet.trace import \
        StarknetExecutionTrace as JT
    claim, witness = stand_in
    port = claim.generate_trace(witness)
    ref = JT(JF, None, claim.public_input, witness)
    assert port.trace_len == ref.trace_len == 1 << 21
    assert sorted(port.base_cols_canonical) == list(range(9))
    for c, col in ref.base_cols_canonical.items():
        assert np.array_equal(port.base_cols_canonical[c], col), c
    assert (port.rc_min, port.rc_max) == (ref.rc_min, ref.rc_max) == \
        (claim.public_input.rc_min, claim.public_input.rc_max)
    rows = np.concatenate([np.arange(1 << 14), np.sort(
        np.random.default_rng(31).choice(1 << 21, 1 << 14, replace=False))])
    got = upload_base_columns(TF, {c: col[rows] for c, col in
                                   port.base_cols_canonical.items()}, CPU)
    for c in range(9):
        w = ref.base_cols_canonical[c][rows].astype(object)
        ints = w[:, 0] + (w[:, 1] << 64) + (w[:, 2] << 128) + (w[:, 3] << 192)
        want = JF.encode_ints_np(ints.tolist())
        assert np.array_equal(to_jax_digits(got[c]), want), c


def test_stand_in_is_deterministic_and_covers_its_instances(stand_in):
    """The claim is the same on a second call; every builtin segment is
    sized by its ratio and holds its instances; the rc128 parts lie in the
    VM's [rc_min, rc_max]; the signatures verify by the AIR's formula."""
    from sandstorm_tpu_torch.builtins import curve, ecdsa
    claim, witness = stand_in
    again, witness2 = starknet_loop_claim(1 << 17, CPU)
    assert again.public_input == claim.public_input
    assert witness2.air_private_input == witness.air_private_input
    pub, priv = claim.public_input, witness.air_private_input
    seg = pub.memory_segments
    n = 1 << 21
    assert seg["output"].begin_addr == seg["output"].stop_ptr \
        == seg["pedersen"].begin_addr
    order = [("pedersen", 3, 512), ("range_check", 1, 256),
             ("ecdsa", 2, 32768), ("bitwise", 5, 1024), ("ec_op", 7, 16384),
             ("poseidon", 6, 512)]
    for (name, cells, rows), (after, _, _) in zip(order, order[1:]):
        assert seg[after].begin_addr == seg[name].begin_addr \
            + cells * (n // rows), name
    for name, cells, _ in order:
        count = len(getattr(priv, name))
        assert count >= 2 and seg[name].stop_ptr - seg[name].begin_addr \
            == cells * count, name
    for inst in priv.range_check:
        v = int(inst["value"], 16)
        parts = [(v >> (16 * k)) & 0xFFFF for k in range(8)]
        assert all(pub.rc_min <= x <= pub.rc_max for x in parts)
    for inst in priv.ecdsa:
        assert ecdsa.verify(int(inst["msg"], 16),
                            int(inst["signature_input"]["r"], 16),
                            int(inst["signature_input"]["w"], 16),
                            int(inst["pubkey"], 16)) is not None
    for inst in priv.ec_op:
        for pt in ("p", "q"):
            assert curve.is_on_curve((int(inst[pt + "_x"], 16),
                                      int(inst[pt + "_y"], 16)))
    assert all(int(inst[f"input_s{k}"], 16) < P
               for inst in priv.poseidon for k in range(3))


def _pinned_starknet():
    """The card's proof of the stand-in (chip_smoke.py phase 10, written by
    tools/profile_prove.py --layout starknet --proof-out) and the sha256
    chip_smoke pins for it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(ROOT, "tests", "data",
                           "starknet_proof_eth.bin"), "rb") as f:
        return f.read(), smoke.STARKNET_SHA256


def test_pinned_starknet_proof_is_the_digest_chip_smoke_pins():
    blob, digest = _pinned_starknet()
    assert hashlib.sha256(blob).hexdigest() == digest


def test_port_verifier_accepts_the_starknet_proof_and_rejects_tampered(
        stand_in):
    """The port's verifier, on the CPU, accepts the card's proof of the
    stand-in at 80 bits and rejects it with one byte flipped."""
    from sandstorm_tpu_torch.stark.ark import parse_proof
    from sandstorm_tpu_torch.stark.verifier import VerificationError
    claim = stand_in[0]
    assert claim.scheme.name == "eth"
    blob, _ = _pinned_starknet()
    proof = parse_proof(blob)
    assert proof.trace_len == 1 << 21
    assert len(proof.execution_ood_evals) == 269
    assert claim.verify(proof, required_security_bits=80)
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x01
    with pytest.raises((VerificationError, AssertionError)):
        claim.verify(parse_proof(bytes(bad)), required_security_bits=80)


def test_jax_verifier_accepts_the_port_starknet_proof(stand_in):
    """The JAX package's verifier (EthVerifierClaim of the same public
    input) accepts the port's proof of the stand-in at 80 bits."""
    from sandstorm_tpu.binary.formats import Layout as JaxLayout
    from sandstorm_tpu.claims import EthVerifierClaim
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.stark.ark import parse_proof as jax_parse
    pub = dataclasses.replace(stand_in[0].public_input,
                              layout=JaxLayout.STARKNET)
    claim = EthVerifierClaim(None, pub, field=JF, layout=JaxLayout.STARKNET)
    blob, _ = _pinned_starknet()
    assert claim.verify(jax_parse(blob), required_security_bits=80)
