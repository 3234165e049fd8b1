"""The starknet layout of the port against the JAX package's, on the CPU:
the builtin witnesses (curve helpers, 128-bit range check, Poseidon, ECDSA,
EC-op), the AIR (constraint DAG, trace arguments, hints, periodic columns)
at 2^15 and 2^21 rows, the extension column, the composition evaluated
over the whole domain and in windows against the host evaluation, the DEEP
composition in windows against one window, and the pinned tiny proof with
both forced into windows.  Every comparison is exact; inputs are made from
numpy seeds.  The 131072-step stand-in's trace and the card's proof of it
are checked in tests/test_torch_starknet_proof.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sandstorm_tpu_torch.claims import (_made_up_ec_ops,
                                        _made_up_signatures,
                                        starknet_loop_claim)
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.interop import to_jax_digits
from sandstorm_tpu_torch.layouts.starknet.air import StarknetAirConfig

CPU = torch.device("cpu")
P = TF.MODULUS
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ints(rng, count, bound=P):
    """`count` python ints below `bound` from a numpy generator."""
    return [int.from_bytes(rng.bytes(32), "little") % bound
            for _ in range(count)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small tensor ops on the CPU: one intra-op thread a
    test worker keeps the workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_claim():
    """The stand-in's claim at 2048 steps (2^15 rows, the smallest the AIR
    takes): its public input carries every builtin segment.  Its trace is
    never built (the diluted padding needs 2^21 rows)."""
    return starknet_loop_claim(2048, CPU)


def _asdict(x):
    return dataclasses.asdict(x)


def test_curve_helpers_match_jax():
    from sandstorm_tpu.builtins import curve as jc
    from sandstorm_tpu_torch.builtins import curve
    assert (curve.FR, curve.GENERATOR) == (jc.FR, jc.GENERATOR)
    assert curve.is_on_curve(curve.GENERATOR) and curve.is_on_curve(None)
    rng = np.random.default_rng(21)
    for x in _ints(rng, 8) + [0, 1]:
        assert curve.sqrt_mod_p(x) == jc.sqrt_mod_p(x)
        assert curve.recover_y(x) == jc.recover_y(x)
        assert curve.inv(x) == pow(x, P - 2, P)
    pt = curve.ec_mul(_ints(rng, 1, curve.FR)[0], curve.GENERATOR)
    assert curve.ec_neg(pt) == jc.ec_neg(pt)
    assert curve.is_on_curve(pt) and curve.is_on_curve(curve.ec_neg(pt))
    assert curve.is_on_curve((pt[0], pt[1] + 1)) == \
        jc.is_on_curve((pt[0], pt[1] + 1)) is False
    assert curve.recover_y(pt[0]) in (pt[1], (-pt[1]) % P)


def test_range_check_matches_jax():
    from sandstorm_tpu.builtins import range_check as jrc
    from sandstorm_tpu_torch.builtins import range_check
    rng = np.random.default_rng(22)
    for i, v in enumerate(_ints(rng, 4, 1 << 128) + [0, (1 << 128) - 1]):
        assert _asdict(range_check.InstanceTrace.new(i, v)) == \
            _asdict(jrc.InstanceTrace.new(i, v))
    with pytest.raises(AssertionError):
        range_check.InstanceTrace.new(0, 1 << 128)


def test_poseidon_matches_jax():
    """The permutation, the optimized-variant InstanceTrace (every round's
    state) and the memoized dummy."""
    from sandstorm_tpu.builtins import poseidon as jp
    from sandstorm_tpu_torch.builtins import poseidon
    assert poseidon.params() == jp.params()
    assert poseidon._DATA != jp._DATA      # the port reads its own copy
    rng = np.random.default_rng(23)
    for i in range(3):
        s = _ints(rng, 3)
        assert poseidon.permute(list(s)) == jp.permute(list(s))
        assert _asdict(poseidon.InstanceTrace.new(i, *s)) == \
            _asdict(jp.InstanceTrace.new(i, *s))
    assert poseidon.hash_two(1, 2) == jp.hash_two(1, 2)
    assert _asdict(poseidon.InstanceTrace.new_dummy(7)) == \
        _asdict(jp.InstanceTrace.new_dummy(7))
    assert len(poseidon.InstanceTrace.new_dummy(0).partial_round_states) \
        == 83


def test_ecdsa_matches_jax():
    """InstanceTrace.new on the stand-in's signatures and the dummy equal
    the JAX package's; verify takes them and refuses a wrong r."""
    from sandstorm_tpu.builtins import ecdsa as je
    from sandstorm_tpu_torch.builtins import ecdsa
    for inst in _made_up_signatures(2, 4):
        args = (int(inst["pubkey"], 16), int(inst["msg"], 16),
                int(inst["signature_input"]["r"], 16),
                int(inst["signature_input"]["w"], 16))
        got = ecdsa.InstanceTrace.new(inst["index"], *args)
        assert _asdict(got) == _asdict(je.InstanceTrace.new(
            inst["index"], *args))
        assert ecdsa.verify(args[1], args[2], args[3], args[0]) == \
            je.verify(args[1], args[2], args[3], args[0]) == got.pubkey
        assert ecdsa.verify(args[1], args[2] + 1, args[3], args[0]) is None
    assert ecdsa.gen_dummy_instance() == je.gen_dummy_instance()
    assert _asdict(ecdsa.InstanceTrace.new_dummy(5)) == \
        _asdict(je.InstanceTrace.new_dummy(5))


def test_ec_op_matches_jax():
    from sandstorm_tpu.builtins import ec_op as jo
    from sandstorm_tpu_torch.builtins import ec_op
    for inst in _made_up_ec_ops(2, 5):
        args = [int(inst[k], 16) for k in ("p_x", "p_y", "q_x", "q_y", "m")]
        assert _asdict(ec_op.InstanceTrace.new(inst["index"], *args)) == \
            _asdict(jo.InstanceTrace.new(inst["index"], *args))
    assert _asdict(ec_op.InstanceTrace.new_dummy(3)) == \
        _asdict(jo.InstanceTrace.new_dummy(3))


@pytest.mark.parametrize("log_n", [15, 21])
def test_air_matches_jax(small_claim, log_n):
    """The 195 constraints walk to the JAX package's node keys, give its
    269 trace arguments on 191 offsets, the 17 hints agree for random
    challenges, and the 9 periodic columns have its coefficients and
    values (symbolic and cheap at 2^21)."""
    from sandstorm_tpu.air.expr import trace_arguments as jax_targs
    from sandstorm_tpu.air.expr import walk as jax_walk
    from sandstorm_tpu.layouts.starknet.air import StarknetAirConfig as JA
    from sandstorm_tpu_torch.air.expr import trace_arguments, walk
    n = 1 << log_n
    g = TF.root_of_unity_int(n)
    port = StarknetAirConfig.constraints(n, P, g)
    ref = JA.constraints(n, P, g)
    assert len(port) == 195
    assert [x.key for x in walk(port)] == [x.key for x in jax_walk(ref)]
    targs = trace_arguments(port)
    assert targs == jax_targs(ref)
    assert len(targs) == 269 and len({off for _, off in targs}) == 191
    pub = small_claim[0].public_input
    rng = np.random.default_rng(log_n)
    ch = _ints(rng, 6)
    hints = StarknetAirConfig.gen_hints(n, pub, ch, P)
    assert len(hints) == 17 and hints == JA.gen_hints(n, pub, ch, P)
    got = StarknetAirConfig.periodic_columns(n)
    want = JA.periodic_columns(n)
    assert len(got) == len(want) == 9
    for pc, rc in zip(got, want):
        assert pc.column.coeffs == rc.column.coeffs
        assert (pc.column.interval, pc.exponent) == \
            (rc.column.interval, rc.exponent)
        for x in _ints(rng, 2):
            assert pc.eval_int(x, P) == rc.eval_int(x, P)


def test_extension_columns_match_jax():
    """The memory / range-check / diluted permutations and the diluted
    aggregate in the one extension column, on random columns (values
    < 2^62) and random challenges."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.layouts.starknet.trace import \
        _build_extension_columns as jax_build
    from sandstorm_tpu_torch.layouts.starknet.trace import \
        _build_extension_columns
    rng = np.random.default_rng(24)
    n = 256
    cols = [np.zeros((n, 4), dtype=np.uint64) for _ in range(3)]
    for c in cols:
        c[:, 0] = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    ch = _ints(rng, 6)
    got = _build_extension_columns(
        TF, *[TF.encode_canonical_u64(c, CPU) for c in cols],
        *TF.encode_ints(ch, CPU).unbind(0))
    want = jax_build(JF, *[JF.encode_canonical_u64(c) for c in cols],
                     *[JF.encode_int(x) for x in ch])
    assert sorted(got) == sorted(want) == [9]
    assert got[9].shape == (n, 8)
    assert np.array_equal(to_jax_digits(got[9]), np.asarray(want[9]))


def test_composition_in_windows_matches_host_evaluation():
    """The 195 constraints over random columns at 2^15 rows, folded with
    alpha powers by evaluate_lde with the periodic columns: over the whole
    domain and in windows of a quarter of it (the ECDSA generator's
    periodic column, of period 2^15, wider than a window, is sliced per
    window) the same values, equal to evaluate_int at 4 points, the last
    two in the last window with trace offsets wrapping around the domain's
    end.  The domain is the trace's own coset (blowup 1): the evaluation is
    pointwise, and the CPU's plain multiply takes 3 us an element."""
    from sandstorm_tpu_torch.air.expr import (IntContext, LdeContext,
                                              evaluate_int, evaluate_lde,
                                              trace_arguments)
    from sandstorm_tpu_torch.stark.prover import _DomainCache
    rng = np.random.default_rng(25)
    n, blowup, coset = 1 << 15, 1, TF.GENERATOR
    N = n * blowup
    vals = {c: _ints(rng, N) for c in range(10)}
    lde = {c: TF.encode_ints(v, CPU) for c, v in vals.items()}
    ch = _ints(rng, 6)
    hints = _ints(rng, 17)
    cons = StarknetAirConfig.constraints(n, P, TF.root_of_unity_int(n))
    periodic = StarknetAirConfig.periodic_columns(n)
    dom = _DomainCache(TF, N, coset, CPU)
    alpha = _ints(rng, 1)[0]
    alpha_pows = TF.encode_ints([pow(alpha, i, P)
                                 for i in range(len(cons))], CPU)

    def fold(acc, v, i):
        t = TF.mul(v, alpha_pows[i])
        return t if acc is None else TF.add(acc, t)

    def composition(chunk_size):
        ctx = LdeContext(TF, lde, blowup, dom.domain, dom.x_pow,
                         challenges=[TF.encode_int(c, CPU) for c in ch],
                         hints=[TF.encode_int(h, CPU) for h in hints],
                         periodic=[pc.lde_fn(TF, dom) for pc in periodic])
        return evaluate_lde(cons, ctx, N, fold=fold, chunk_size=chunk_size)

    whole = composition(None)
    windows = composition(N // 4)
    assert torch.equal(whole, windows)
    comp = TF.decode_ints(whole)
    w = TF.root_of_unity_int(N)
    for i in (0, 5, N - 300, N - 1):
        x = coset * pow(w, i, P) % P
        tv = {(c, off): vals[c][(i + off * blowup) % N]
              for (c, off) in trace_arguments(cons)}
        cv = evaluate_int(cons, IntContext(
            P, x, tv, ch, hints, [pc.eval_int(x, P) for pc in periodic]))
        assert comp[i] == sum(v * pow(alpha, k, P)
                              for k, v in enumerate(cv)) % P


def test_deep_in_windows_matches_one_window(monkeypatch):
    """_deep_compose over the starknet trace arguments (192 points) on
    random LDE columns: in windows of a quarter of the domain the same
    values as in one window."""
    from sandstorm_tpu_torch.air.expr import trace_arguments
    from sandstorm_tpu_torch.stark import prover
    from sandstorm_tpu_torch.stark.prover import _DomainCache, _deep_compose
    rng = np.random.default_rng(26)
    n, blowup = 1 << 9, 2
    N = n * blowup
    targs = trace_arguments(StarknetAirConfig.constraints(
        1 << 15, P, TF.root_of_unity_int(1 << 15)))
    trace_lde = {c: TF.encode_ints(_ints(rng, N), CPU) for c in range(10)}
    comp_lde = [TF.encode_ints(_ints(rng, N), CPU) for _ in range(2)]
    tvals, cvals = _ints(rng, len(targs)), _ints(rng, 2)
    z, alpha = _ints(rng, 2)
    dom = _DomainCache(TF, N, TF.GENERATOR, CPU)
    g = TF.root_of_unity_int(n)
    one = _deep_compose(TF, dom, targs, trace_lde, comp_lde, tvals, cvals,
                        z, g, n, alpha)
    assert prover.LAST_CHUNKS["DEEP composition"] == 1
    monkeypatch.setattr(prover, "deep_chunk_size", lambda F, N, K: N // 4)
    four = _deep_compose(TF, dom, targs, trace_lde, comp_lde, tvals, cvals,
                         z, g, n, alpha)
    assert prover.LAST_CHUNKS["DEEP composition"] == 4
    assert one.shape == (N, 8) and torch.equal(one, four)
    # one term by hand: the first row against python ints
    x = TF.GENERATOR
    offsets = sorted({off for _, off in targs})
    want, coeff = 0, 1
    for j, (col, off) in enumerate(targs):
        pt = z * pow(g, off % n, P) % P
        want += coeff * (TF.decode_ints(trace_lde[col][:1])[0] - tvals[j]) \
            * pow(x - pt, -1, P)
        coeff = coeff * alpha % P
    for l in range(2):
        want += coeff * (TF.decode_ints(comp_lde[l][:1])[0] - cvals[l]) \
            * pow(x - pow(z, 2, P), -1, P)
        coeff = coeff * alpha % P
    assert len(offsets) + 1 == 192
    assert TF.decode_ints(one[:1])[0] == want % P


def test_tiny_proof_in_windows_is_the_pinned_proof(monkeypatch):
    """The tiny generic proof with the constraint evaluation in windows of
    128 rows and DEEP in windows of 64 equals
    tests/data/self_proof_generic.bin: the windows change no byte."""
    from sandstorm_tpu_torch.claims import loop_claim
    from sandstorm_tpu_torch.stark import prover
    from sandstorm_tpu_torch.stark.ark import serialize_proof
    from sandstorm_tpu_torch.stark.options import ProofOptions
    monkeypatch.setattr(prover, "constraint_chunk_size", lambda F, N: 128)
    monkeypatch.setattr(prover, "deep_chunk_size", lambda F, N, K: 64)
    claim, witness = loop_claim(16, CPU, scheme="generic")
    blob = serialize_proof(claim.prove(
        witness, ProofOptions(num_queries=4, proof_of_work_bits=4)))
    assert prover.LAST_CHUNKS == {"constraint evaluation": 4,
                                  "DEEP composition": 8}
    with open(os.path.join(ROOT, "tests", "data",
                           "self_proof_generic.bin"), "rb") as f:
        assert blob == f.read()
