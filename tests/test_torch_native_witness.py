"""The port's native lockstep builtin witness batch (native/ecdsa.cpp, built
from the port's own copy) on the CPU: the ECDSA, EC-op and Pedersen batches
against the port's python `new` and the JAX package's native batch
(`_new_batch_native`) at tens of instances and on the dummy templates; the
inputs the AIR refuses raise; the limb shift and bit helpers against
python ints; the columns the trace builders fill from the batch's limbs
against the JAX package's traces and against the same builders fed by the
python `new` (the batch replaced by a plain version built from `new`, by
monkeypatch): the starknet stand-in partly filled, the recursive one with
64 Pedersen instances and, marked slow, starknet-eth-2^21-ec with every
slot filled; and the card's proof of starknet-eth-2^21-ec
(tests/data/starknet_ec_proof_eth.bin).  Every comparison is exact
(tolerance 0); inputs are made from numpy seeds."""

import ctypes
import dataclasses
import hashlib
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from sandstorm_tpu_torch import native
from sandstorm_tpu_torch.builtins import curve, ec_op, ecdsa, pedersen
from sandstorm_tpu_torch.claims import (_made_up_ec_ops, _made_up_signatures,
                                        recursive_loop_claim,
                                        starknet_ec_counts,
                                        starknet_loop_claim)
from sandstorm_tpu_torch.layouts.utils import (ints_to_u64limbs,
                                               u64limbs_bit, u64limbs_shr,
                                               u64limbs_to_ints)

CPU = torch.device("cpu")
P = curve.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = (1 << 251) | (1 << 196) | (1 << 192)
SHIFTS = [0, 63, 64, 65, 128, 192, 255]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ints(rng, count, bound=P):
    return [int.from_bytes(rng.bytes(32), "little") % bound
            for _ in range(count)]


def _asdict(traces):
    return [dataclasses.asdict(t) for t in traces]


def _pedersen_items():
    """40 (index, a, b): zeros, inputs with bits 251, 196 and 192 set (the
    flags of the unique-unpacking constraints), p - 1, random felts."""
    rng = np.random.default_rng(41)
    edge = [(0, 0), (TOP, TOP + 5), (1, P - 1), (1 << 251, 1 << 196),
            (1 << 192, 0), (P - 1, TOP)]
    rand = list(zip(_ints(rng, 34), _ints(rng, 34, 1 << 251)))
    return [(i, a, b) for i, (a, b) in enumerate(edge + rand)]


def _signature(priv, seed):
    """(pubkey_x, message, r, w) signed by `priv` with a nonce from seed."""
    rng = np.random.default_rng(seed)
    while True:
        msg = _ints(rng, 1, 1 << 251)[0]
        sig = ecdsa.sign(priv, msg, _ints(rng, 1, curve.FR - 1)[0] + 1)
        if msg and sig is not None:
            return curve.ec_mul(priv, curve.GENERATOR)[0], msg, *sig


def _ecdsa_items():
    """6 signatures: the stand-in's 4, and one by each of the private keys
    k and FR - k, whose public keys share x and differ in y: one of them is
    not recover_y's and takes the batch's second call, mirrored."""
    made = [(s["index"], int(s["pubkey"], 16), int(s["msg"], 16),
             int(s["signature_input"]["r"], 16),
             int(s["signature_input"]["w"], 16))
            for s in _made_up_signatures(4, 4)]
    k = _ints(np.random.default_rng(43), 1, curve.FR - 1)[0] + 1
    return made + [(4, *_signature(k, 44)), (5, *_signature(curve.FR - k, 45))]


def _ec_op_items():
    return [(o["index"], *(int(o[k], 16) for k in
                           ("p_x", "p_y", "q_x", "q_y", "m")))
            for o in _made_up_ec_ops(12, 5)]


def test_pedersen_batch_matches_python_and_jax():
    from sandstorm_tpu.builtins import pedersen as jp
    items = _pedersen_items()
    got = pedersen.InstanceTrace.new_batch(items)
    assert _asdict(got) == _asdict(
        [pedersen.InstanceTrace.new(*it) for it in items])
    assert _asdict(got) == _asdict(
        jp._new_batch_native(jp.InstanceTrace, items))
    assert any(t.a_bit251_and_bit196_and_bit192 for t in got)
    assert any(t.b_bit251_and_bit196 for t in got)


def test_ecdsa_batch_matches_python_and_jax():
    from sandstorm_tpu.builtins import ecdsa as je
    items = _ecdsa_items()
    got = ecdsa.InstanceTrace.new_batch(items)
    assert _asdict(got) == _asdict(
        [ecdsa.InstanceTrace.new(*it) for it in items])
    assert _asdict(got) == _asdict(
        je._new_batch_native(je.InstanceTrace, items))
    # the pair with one x: exactly one public key is recover_y's
    mirrored = [t.pubkey[1] != curve.recover_y(t.pubkey_x) for t in got[4:]]
    assert sorted(mirrored) == [False, True]
    wl = ecdsa.witness_limbs(items)
    assert list(u64limbs_to_ints(wl.pubkey_y)) == [t.pubkey[1] for t in got]
    assert list(u64limbs_to_ints(wl.pubkey_x_squared)) == \
        [t.pubkey_x ** 2 % P for t in got]


def test_ec_op_batch_matches_python_and_jax():
    from sandstorm_tpu.builtins import ec_op as jo
    items = _ec_op_items()
    got = ec_op.InstanceTrace.new_batch(items)
    assert _asdict(got) == _asdict(
        [ec_op.InstanceTrace.new(*it) for it in items])
    assert _asdict(got) == _asdict(
        jo._new_batch_native(jo.InstanceTrace, items))


def _dummy_items():
    p0 = pedersen.shift_and_table_points()[0]
    return {"pedersen": (pedersen, (0, 0, 0)),
            "ecdsa": (ecdsa, (0, *ecdsa.gen_dummy_instance())),
            "ec_op": (ec_op, (0, *p0, *curve.GENERATOR, 1))}


@pytest.mark.parametrize("name", ["pedersen", "ecdsa", "ec_op"])
def test_dummy_templates_match(name):
    """The memoized dummy (new_batch) equals the python `new` of the same
    instance and the JAX package's dummy; its limbs (dummy_limbs, which the
    trace builders tile) equal witness_limbs of the same item."""
    import importlib
    jax_mod = importlib.import_module(f"sandstorm_tpu.builtins.{name}")
    module, item = _dummy_items()[name]
    got = module.InstanceTrace.new_dummy(7)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        dataclasses.replace(module.InstanceTrace.new(*item), index=7))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_mod.InstanceTrace.new_dummy(7))
    want = module.witness_limbs([item])
    for field in dataclasses.fields(want):
        assert np.array_equal(getattr(module.dummy_limbs(), field.name),
                              getattr(want, field.name)), field.name


@pytest.mark.parametrize("case", ["signature", "ec_op", "pedersen"])
def test_inputs_the_air_refuses_raise(case):
    """An invalid signature (r + 1), an EC op whose first partial sum
    shares its x with the addend (p = q), a Pedersen input past the 252
    bits of the chain: the python `new` and the native batch both raise."""
    if case == "signature":
        idx, x, m, r, w = _ecdsa_items()[0]
        module, item = ecdsa, (idx, x, m, r + 1, w)
    elif case == "ec_op":
        module, item = ec_op, (0, *curve.GENERATOR, *curve.GENERATOR, 1)
    else:
        module, item = pedersen, (0, 1 << 252, 0)
    with pytest.raises((AssertionError, IndexError)):
        module.InstanceTrace.new(*item)
    with pytest.raises(AssertionError):
        module.InstanceTrace.new_batch([item])
    with pytest.raises(AssertionError):
        module.witness_limbs([item])


def test_unset_library_state_raises(tmp_path, monkeypatch):
    """A copy of the library whose parameters and chains were never set
    returns -1 from the ECDSA and Pedersen batches, and the loaders
    raise."""
    native._witness_lib()
    copy = tmp_path / "libfresh.so"
    shutil.copy(native.library_path("witness"), copy)
    fresh = ctypes.CDLL(str(copy))
    for entry in ("ecdsa_witness_batch", "pedersen_witness_batch"):
        getattr(fresh, entry).restype = ctypes.c_int
    monkeypatch.setattr(native, "_witness_lib", lambda: fresh)
    with pytest.raises(RuntimeError, match="not set"):
        native.pedersen_witness_batch([1], [2])
    with pytest.raises(RuntimeError, match="not set"):
        native.ecdsa_witness_batch([1], [2], [3], [4], [5])


def test_witness_library_is_built_from_the_port_sources(monkeypatch,
                                                        tmp_path):
    """The library is ecdsa.cpp and fe252.h of the port's native/, its name
    keyed by both and the flags; the port's code lines equal the JAX
    package's (only the comments differ)."""
    srcs = native.SOURCES["witness"]
    assert [s.name for s in srcs] == ["ecdsa.cpp", "fe252.h"]
    assert all(s.parent == native.HERE for s in srcs)
    name = native.library_path("witness")
    for i in range(2):
        changed = tmp_path / f"{i}_{srcs[i].name}"
        changed.write_bytes(srcs[i].read_bytes() + b"\n")
        monkeypatch.setitem(native.SOURCES, "witness",
                            tuple(changed if j == i else s
                                  for j, s in enumerate(srcs)))
        assert native.library_path("witness") != name
    monkeypatch.setitem(native.SOURCES, "witness", srcs)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-g"])
    assert native.library_path("witness") != name

    def code(path):
        return [line for line in path.read_text().splitlines()
                if line.strip() and not line.lstrip().startswith("//")]

    for src in srcs:
        jax_src = native.HERE.parents[1] / "sandstorm_tpu" / "native" / src.name
        assert code(src) == code(jax_src), src.name


@pytest.mark.parametrize("shift", SHIFTS)
def test_limb_shift_matches_python_ints(shift):
    rng = np.random.default_rng(shift)
    vals = _ints(rng, 16, 1 << 256) + [0, 1, (1 << 256) - 1, TOP, P - 1,
                                       1 << 63, 1 << 64, 1 << 191]
    got = u64limbs_shr(ints_to_u64limbs(vals), [shift, 0, 255])
    assert got.shape == (len(vals), 3, 4)
    for j, s in enumerate([shift, 0, 255]):
        assert list(u64limbs_to_ints(got[:, j])) == [v >> s for v in vals]


@pytest.mark.parametrize("bit", [0, 63, 64, 192, 196, 251, 255])
def test_limb_bit_matches_python_ints(bit):
    vals = _ints(np.random.default_rng(bit), 32, 1 << 256) + [0, TOP]
    assert list(u64limbs_bit(ints_to_u64limbs(vals), bit)) == \
        [bool((v >> bit) & 1) for v in vals]


# -- the batch's plain version, built from `new` -------------------------------

def _pedersen_plain(a, b):
    out = []
    for x, y in zip(u64limbs_to_ints(a), u64limbs_to_ints(b)):
        t = pedersen.InstanceTrace.new(0, x, y)
        steps = t.a_steps + t.b_steps
        out.append([v for s in steps for v in (*s.point, s.slope)]
                   + list(t.b_steps[-1].point))
    return ints_to_u64limbs(v for row in out for v in row).reshape(
        len(out), -1, 4), np.zeros(len(out), dtype=np.int32)


def _mad(steps):
    return [v for s in steps for v in (*s.partial_sum, *s.fixed_point,
                                       s.slope, s.x_diff_inv)]


def _dbl(steps):
    return [v for s in steps for v in (*s.point, s.slope)]


def _ecdsa_plain(msg, r, w, pubx, puby):
    """status 1 where puby is not the y that verifies, as the lockstep
    fails on the wrong y."""
    out, status = [], []
    for m, rr, ww, x, y in zip(*(u64limbs_to_ints(v)
                                 for v in (msg, r, w, pubx, puby))):
        t = ecdsa.InstanceTrace.new(0, x, m, rr, ww)
        status.append(int(t.pubkey[1] != y))
        zg, rq, wb = (s[-1].partial_sum for s in (t.zg_steps, t.rq_steps,
                                                   t.wb_steps))
        out.append(_mad(t.zg_steps) + _mad(t.rq_steps) + _mad(t.wb_steps)
                   + _dbl(t.pubkey_doubling_steps) + _dbl(t.b_doubling_steps)
                   + [*zg, *rq, *t.b, t.b_slope, t.b_x_diff_inv, *wb,
                      t.r_point_slope, t.r_point_x_diff_inv, rr, t.w_inv,
                      t.r_inv, t.message_inv])
    return ints_to_u64limbs(v for row in out for v in row).reshape(
        len(out), -1, 4), np.asarray(status, dtype=np.int32)


def _ec_op_plain(px, py, qx, qy, m):
    out = []
    for vals in zip(*(u64limbs_to_ints(v) for v in (px, py, qx, qy, m))):
        t = ec_op.InstanceTrace.new(0, *vals)
        out.append(_mad(t.r_steps) + _dbl(t.q_doubling_steps) + list(t.r))
    return ints_to_u64limbs(v for row in out for v in row).reshape(
        len(out), -1, 4), np.zeros(len(out), dtype=np.int32)


def _clear_dummies():
    for module in (pedersen, ecdsa, ec_op):
        module.dummy_limbs.cache_clear()


@pytest.fixture
def python_route(monkeypatch):
    """A switch to the python route: the batch calls answered by the plain
    version built from `new` (the memoized dummy limbs dropped at the
    switch and at teardown)."""
    def switch():
        _clear_dummies()
        monkeypatch.setattr(native, "pedersen_witness_batch", _pedersen_plain)
        monkeypatch.setattr(native, "ecdsa_witness_batch", _ecdsa_plain)
        monkeypatch.setattr(native, "ec_op_witness_batch", _ec_op_plain)

    yield switch
    _clear_dummies()


def test_plain_batch_matches_native():
    """The plain version gives the native batch's bytes and status."""
    items = _pedersen_items()[:6]
    a, b = (ints_to_u64limbs(it[j] for it in items) for j in (1, 2))
    for got, want in zip(_pedersen_plain(a, b),
                         native.pedersen_witness_batch(a, b)):
        assert np.array_equal(got, want)
    cols = [ints_to_u64limbs(it[j] for it in _ecdsa_items())
            for j in (2, 3, 4, 1)]
    cols.append(ints_to_u64limbs(curve.recover_y(x)
                                 for x in u64limbs_to_ints(cols[3])))
    got, want = _ecdsa_plain(*cols), native.ecdsa_witness_batch(*cols)
    assert np.array_equal(got[1] != 0, want[1] != 0)
    ok = want[1] == 0
    assert np.array_equal(got[0][ok], want[0][ok])
    # the others verify with the mirrored y, in both
    retry = [c[~ok] for c in cols[:4]]
    retry.append(ints_to_u64limbs(P - y for y in u64limbs_to_ints(
        cols[4][~ok])))
    got, want = _ecdsa_plain(*retry), native.ecdsa_witness_batch(*retry)
    assert not got[1].any() and not want[1].any()
    assert len(retry[0]) and np.array_equal(got[0], want[0])
    cols = [ints_to_u64limbs(it[j] for it in _ec_op_items()[:4])
            for j in range(1, 6)]
    for got, want in zip(_ec_op_plain(*cols),
                         native.ec_op_witness_batch(*cols)):
        assert np.array_equal(got, want)


def _columns(claim, witness):
    return claim.generate_trace(witness).base_cols_canonical


def _same_columns(got, want, count):
    assert sorted(got) == sorted(want) == list(range(count))
    for c in range(count):
        assert np.array_equal(got[c], want[c]), c


@pytest.fixture(scope="module")
def partial_fill():
    return starknet_loop_claim(1 << 17, CPU, pedersen=256, ecdsa=8,
                               ec_op=16)


def test_starknet_partial_fill_matches_jax(partial_fill):
    """The 9 base columns of starknet_loop_claim(131072, pedersen=256,
    ecdsa=8, ec_op=16), filled from the batch's limbs, equal the JAX
    package's StarknetExecutionTrace of the same public input and
    witness."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.layouts.starknet.trace import \
        StarknetExecutionTrace as JT
    claim, witness = partial_fill
    ref = JT(JF, None, claim.public_input, witness)
    _same_columns(_columns(claim, witness), ref.base_cols_canonical, 9)


def test_starknet_partial_fill_matches_python_route(partial_fill,
                                                    python_route):
    """The same 9 columns equal the builder's on the python route."""
    claim, witness = partial_fill
    got = _columns(claim, witness)
    python_route()
    _same_columns(got, _columns(claim, witness), 9)


@pytest.fixture(scope="module")
def recursive_fill():
    return recursive_loop_claim(16384, CPU, pedersen=64)


def test_recursive_pedersen_fill_matches_jax_and_python_route(
        recursive_fill, python_route):
    """The 7 base columns of recursive_loop_claim(16384, pedersen=64)
    equal the JAX package's RecursiveExecutionTrace and the same builder's
    columns on the python route."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.layouts.recursive.trace import \
        RecursiveExecutionTrace as JT
    claim, witness = recursive_fill
    got = _columns(claim, witness)
    ref = JT(JF, None, claim.public_input, witness)
    _same_columns(got, ref.base_cols_canonical, 7)
    python_route()
    _same_columns(got, _columns(claim, witness), 7)


@pytest.mark.slow
def test_starknet_full_load_matches_jax():
    """starknet-eth-2^21-ec: every Pedersen, ECDSA and EC-op slot filled
    (4096, 64, 128); its 9 base columns equal the JAX package's (minutes on
    the CPU: the JAX builder's dataclass hand-off)."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.layouts.starknet.trace import \
        StarknetExecutionTrace as JT
    claim, witness = starknet_loop_claim(1 << 17, CPU,
                                         **starknet_ec_counts(1 << 17))
    ref = JT(JF, None, claim.public_input, witness)
    _same_columns(_columns(claim, witness), ref.base_cols_canonical, 9)


# -- the card's proof of starknet-eth-2^21-ec ----------------------------------

@pytest.fixture(scope="module")
def full_load_claim():
    """starknet-eth-2^21-ec's claim (the verifier reads its public input:
    the builtin segments sized by the counts)."""
    return starknet_loop_claim(1 << 17, CPU, **starknet_ec_counts(1 << 17))[0]


def _pinned_starknet_ec():
    """The card's proof of starknet-eth-2^21-ec (chip_smoke.py phase 10b's
    claim, proved through `python -m sandstorm_tpu_torch prove` at the
    default options) and the sha256 chip_smoke pins for it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(ROOT, "tests", "data",
                           "starknet_ec_proof_eth.bin"), "rb") as f:
        return f.read(), smoke.STARKNET_EC_SHA256


@pytest.mark.parametrize("arg", ["ecdsa", "ecdsa=x", "keccak=4"])
def test_bundle_writer_refuses_a_malformed_count(arg, tmp_path):
    from sandstorm_tpu_torch.tools import make_artifacts
    with pytest.raises(SystemExit, match="BUILTIN=COUNT"):
        make_artifacts.main([str(tmp_path), "131072", "starknet", arg])
    assert not any(tmp_path.iterdir())


def test_starknet_ec_counts_fill_every_slot(full_load_claim):
    assert starknet_ec_counts(1 << 17) == {"pedersen": 4096, "ecdsa": 64,
                                           "ec_op": 128}
    seg = full_load_claim.public_input.memory_segments
    for name, cells, count in (("pedersen", 3, 4096), ("ecdsa", 2, 64),
                               ("ec_op", 7, 128)):
        assert seg[name].stop_ptr - seg[name].begin_addr == cells * count


def test_pinned_starknet_ec_proof_is_the_digest_chip_smoke_pins():
    blob, digest = _pinned_starknet_ec()
    assert hashlib.sha256(blob).hexdigest() == digest


def test_port_verifier_accepts_the_starknet_ec_proof_and_rejects_tampered(
        full_load_claim):
    from sandstorm_tpu_torch.stark.ark import parse_proof
    from sandstorm_tpu_torch.stark.verifier import VerificationError
    blob, _ = _pinned_starknet_ec()
    proof = parse_proof(blob)
    assert proof.trace_len == 1 << 21
    assert full_load_claim.verify(proof, required_security_bits=80)
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x01
    with pytest.raises((VerificationError, AssertionError)):
        full_load_claim.verify(parse_proof(bytes(bad)),
                               required_security_bits=80)


def test_jax_verifier_accepts_the_port_starknet_ec_proof(full_load_claim):
    """The JAX package's EthVerifierClaim of the same public input accepts
    the card's proof at 80 bits."""
    from sandstorm_tpu.binary.formats import Layout as JaxLayout
    from sandstorm_tpu.claims import EthVerifierClaim
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.stark.ark import parse_proof as jax_parse
    pub = dataclasses.replace(full_load_claim.public_input,
                              layout=JaxLayout.STARKNET)
    claim = EthVerifierClaim(None, pub, field=JF, layout=JaxLayout.STARKNET)
    blob, _ = _pinned_starknet_ec()
    assert claim.verify(jax_parse(blob), required_security_bits=80)
