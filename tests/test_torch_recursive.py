"""The recursive layout of the port against the JAX package's, on the CPU:
the 16384-step stand-in's trace columns, the AIR (constraint DAG, trace
arguments, hints), the periodic Pedersen columns, the extension columns,
the composition with periodic columns against the host evaluation, the
affine prefix scan and the Pedersen and bitwise builtin witnesses.  Every
comparison is exact; inputs are made from numpy seeds.  The stand-in's
proof is checked in tests/test_torch_recursive_proof.py."""

import types

import numpy as np
import pytest
import torch

from sandstorm_tpu_torch.claims import recursive_loop_claim
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.interop import to_jax_digits
from sandstorm_tpu_torch.layouts.recursive.air import RecursiveAirConfig

CPU = torch.device("cpu")
P = TF.MODULUS


def _ints(rng, count, bound=P):
    """`count` python ints below `bound` from a numpy generator."""
    return [int.from_bytes(rng.bytes(32), "little") % bound
            for _ in range(count)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests issue thousands of small tensor ops on the CPU.  With
    several test workers on one machine, torch's intra-op threads
    oversubscribe the cores and every op waits for all of its threads
    (the composition test took minutes instead of seconds); one thread a
    worker keeps the file near its single-core time, about a minute."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stand_in():
    claim, witness = recursive_loop_claim(16384, CPU)
    return claim, witness, claim.generate_trace(witness)


def test_stand_in_columns_match_jax(stand_in):
    """The seven base columns of the 16384-step stand-in, rc_min / rc_max
    and the uploaded columns equal the JAX package's trace of the same
    public input and witness (the uploads against the JAX package's host
    Montgomery encoding of its columns: its device upload takes half a
    minute on the CPU)."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.layouts.recursive.trace import \
        RecursiveExecutionTrace as JT
    claim, witness, port = stand_in
    ref = JT(JF, None, claim.public_input, witness)
    assert port.trace_len == ref.trace_len == 1 << 18
    assert sorted(port.base_cols_canonical) == list(range(7))
    for c, col in ref.base_cols_canonical.items():
        assert np.array_equal(port.base_cols_canonical[c], col), c
    assert (port.rc_min, port.rc_max) == (ref.rc_min, ref.rc_max)
    got = port.base_columns()
    for c in range(7):
        w = ref.base_cols_canonical[c].astype(object)
        ints = w[:, 0] + (w[:, 1] << 64) + (w[:, 2] << 128) + (w[:, 3] << 192)
        want = JF.encode_ints_np(ints.tolist())
        assert np.array_equal(to_jax_digits(got[c]), want), c


def test_stand_in_is_deterministic_and_covers_its_instances(stand_in):
    claim, witness, _ = stand_in
    again, witness2 = recursive_loop_claim(16384, CPU)
    assert again.public_input == claim.public_input
    assert witness2.air_private_input == witness.air_private_input
    assert np.array_equal(witness2.register_states.arr,
                          witness.register_states.arr)
    seg = claim.public_input.memory_segments
    priv = witness.air_private_input
    assert seg["output"].begin_addr == seg["output"].stop_ptr \
        == seg["pedersen"].begin_addr
    assert seg["pedersen"].stop_ptr - seg["pedersen"].begin_addr \
        == 3 * len(priv.pedersen) == 9
    assert seg["bitwise"].stop_ptr - seg["bitwise"].begin_addr \
        == 5 * len(priv.bitwise) == 15
    assert seg["range_check"].begin_addr == seg["range_check"].stop_ptr
    assert all(int(i["x"], 16) < 1 << 251 and int(i["y"], 16) < 1 << 251
               for i in priv.pedersen + priv.bitwise)


@pytest.mark.parametrize("log_n", [14, 18])
def test_air_matches_jax(stand_in, log_n):
    """The 93 constraints walk to the JAX package's node keys, give its
    133 trace arguments, and the hints agree for random challenges."""
    from sandstorm_tpu.air.expr import trace_arguments as jax_targs
    from sandstorm_tpu.air.expr import walk as jax_walk
    from sandstorm_tpu.layouts.recursive.air import RecursiveAirConfig as JA
    from sandstorm_tpu_torch.air.expr import trace_arguments, walk
    n = 1 << log_n
    g = TF.root_of_unity_int(n)
    port = RecursiveAirConfig.constraints(n, P, g)
    ref = JA.constraints(n, P, g)
    assert len(port) == 93
    assert [x.key for x in walk(port)] == [x.key for x in jax_walk(ref)]
    targs = trace_arguments(port)
    assert targs == jax_targs(ref)
    assert len(targs) == 133 and len({off for _, off in targs}) == 72
    pub = stand_in[0].public_input
    ch = _ints(np.random.default_rng(log_n), 6)
    assert RecursiveAirConfig.gen_hints(n, pub, ch, P) == \
        JA.gen_hints(n, pub, ch, P)


def test_periodic_columns_match_jax():
    """The Pedersen periodic columns: the same coefficients, the same
    values at random points, and the same values on the LDE domain at
    n = 2048, blowup 2."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.layouts.recursive.air import RecursiveAirConfig as JA
    rng = np.random.default_rng(7)
    for n in (2048, 1 << 18):
        port = RecursiveAirConfig.periodic_columns(n)
        ref = JA.periodic_columns(n)
        assert len(port) == len(ref) == 2
        for pc, rc in zip(port, ref):
            assert pc.column.coeffs == rc.column.coeffs
            assert pc.exponent == rc.exponent == n // 2048
            for x in _ints(rng, 3):
                assert pc.eval_int(x, P) == rc.eval_int(x, P)
    N, coset = 4096, TF.GENERATOR
    dom = types.SimpleNamespace(N=N, coset=coset, device=CPU)
    for pc, rc in zip(RecursiveAirConfig.periodic_columns(2048),
                      JA.periodic_columns(2048)):
        got = pc.lde_fn(TF, dom)()
        assert got.shape == (N, 8)
        assert np.array_equal(to_jax_digits(got),
                              np.asarray(rc.lde_fn(JF, dom)()))


def test_extension_columns_match_jax():
    """The memory / range-check / diluted permutations and the diluted
    aggregate on random columns (values < 2^62) and random challenges."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.layouts.recursive.trace import \
        _build_extension_columns as jax_build
    from sandstorm_tpu_torch.layouts.recursive.trace import \
        _build_extension_columns
    rng = np.random.default_rng(11)
    n = 256
    cols = [np.zeros((n, 4), dtype=np.uint64) for _ in range(5)]
    for c in cols:
        c[:, 0] = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    ch = _ints(rng, 6)
    got = _build_extension_columns(
        TF, *[TF.encode_canonical_u64(c, CPU) for c in cols],
        *TF.encode_ints(ch, CPU).unbind(0))
    want = jax_build(JF, *[JF.encode_canonical_u64(c) for c in cols],
                     *[JF.encode_int(x) for x in ch])
    assert sorted(got) == sorted(want) == [7, 8, 9]
    for k in (7, 8, 9):
        assert got[k].shape == (n, 8)
        assert np.array_equal(to_jax_digits(got[k]), np.asarray(want[k])), k


def _affine(F):
    def compose(fst, snd):
        a1, b1 = fst
        a2, b2 = snd
        return F.mul(a1, a2), F.add(F.mul(b1, a2), b2)
    return compose


@pytest.mark.parametrize("reverse", [False, True])
def test_affine_prefix_scan(reverse):
    """prefix_scan with the affine combine equals a python-int fold of the
    maps and the JAX prefix_scan (37 rows: not a power of two)."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.fields.scan import prefix_scan as jax_scan
    from sandstorm_tpu_torch.fields.scan import prefix_scan
    rng = np.random.default_rng(3 + reverse)
    n = 37
    a, b = _ints(rng, n), _ints(rng, n)
    ga, gb = prefix_scan(_affine(TF), (TF.encode_ints(a, CPU),
                                       TF.encode_ints(b, CPU)), reverse)
    # the composed map of rows 0..k (forward) or k..n-1 (reverse), applied
    # in row order: acc -> acc a_i + b_i
    want = []
    order = range(n - 1, -1, -1) if reverse else range(n)
    ca, cb = 1, 0
    for i in order:
        if reverse:   # prepend map i: first (a_i, b_i), then (ca, cb)
            ca, cb = a[i] * ca % P, (b[i] * ca + cb) % P
        else:         # append map i
            ca, cb = ca * a[i] % P, (cb * a[i] + b[i]) % P
        want.append((ca, cb))
    if reverse:
        want.reverse()
    assert list(zip(TF.decode_ints(ga), TF.decode_ints(gb))) == want
    ja, jb = jax_scan(_affine(JF), (JF.encode_ints(a), JF.encode_ints(b)),
                      reverse=reverse)
    assert np.array_equal(to_jax_digits(ga), np.asarray(ja))
    assert np.array_equal(to_jax_digits(gb), np.asarray(jb))


def test_composition_with_periodic_columns_matches_host_evaluation():
    """The 93 constraints over random LDE columns (n = 4096, blowup 2),
    folded with alpha powers by evaluate_lde with the periodic columns,
    equal evaluate_int with the periodic values at 4 domain points."""
    from sandstorm_tpu_torch.air.expr import (IntContext, LdeContext,
                                              evaluate_int, evaluate_lde,
                                              trace_arguments)
    from sandstorm_tpu_torch.stark.prover import _DomainCache
    rng = np.random.default_rng(5)
    n, blowup, coset = 4096, 2, TF.GENERATOR
    N = n * blowup
    vals = {c: _ints(rng, N) for c in range(10)}
    lde = {c: TF.encode_ints(v, CPU) for c, v in vals.items()}
    ch = _ints(rng, 6)
    hints = _ints(rng, 14)
    cons = RecursiveAirConfig.constraints(n, P, TF.root_of_unity_int(n))
    periodic = RecursiveAirConfig.periodic_columns(n)
    dom = _DomainCache(TF, N, coset, CPU)
    alpha = _ints(rng, 1)[0]
    ctx = LdeContext(TF, lde, blowup, dom.domain, dom.x_pow,
                     challenges=[TF.encode_int(c, CPU) for c in ch],
                     hints=[TF.encode_int(h, CPU) for h in hints],
                     periodic=[pc.lde_fn(TF, dom) for pc in periodic])

    def fold(acc, v, i):
        t = TF.mul(v, TF.encode_int(pow(alpha, i, P), CPU))
        return t if acc is None else TF.add(acc, t)

    comp = TF.decode_ints(evaluate_lde(cons, ctx, N, fold=fold))
    w = TF.root_of_unity_int(N)
    for i in (0, 1, 2049, N - 1):
        x = coset * pow(w, i, P) % P
        tv = {(c, off): vals[c][(i + off * blowup) % N]
              for (c, off) in trace_arguments(cons)}
        cv = evaluate_int(cons, IntContext(
            P, x, tv, ch, hints, [pc.eval_int(x, P) for pc in periodic]))
        assert comp[i] == sum(v * pow(alpha, k, P)
                              for k, v in enumerate(cv)) % P


def _steps(steps):
    return [(s.point, s.suffix, s.slope) for s in steps]


def _same_pedersen_trace(got, want):
    assert (got.index, got.a, got.b, got.output) == \
        (want.index, want.a, want.b, want.output)
    assert _steps(got.a_steps) == _steps(want.a_steps)
    assert _steps(got.b_steps) == _steps(want.b_steps)
    for flag in ("a_bit251_and_bit196_and_bit192", "a_bit251_and_bit196",
                 "b_bit251_and_bit196_and_bit192", "b_bit251_and_bit196"):
        assert getattr(got, flag) == getattr(want, flag), flag


def test_pedersen_builtin_matches_jax():
    """InstanceTrace.new for a few (a, b), among them inputs with bits 251,
    196 and 192 set; the dummy instance; the periodic table points."""
    from sandstorm_tpu.builtins import pedersen as jax_ped
    from sandstorm_tpu_torch.builtins import pedersen
    rng = np.random.default_rng(13)
    top = (1 << 251) | (1 << 196) | (1 << 192)
    items = [(0, 0, 0), (1, *_ints(rng, 2, 1 << 251)), (2, top, top + 5),
             (3, 1, P - 1)]
    for got, want in zip(pedersen.InstanceTrace.new_batch(items),
                         jax_ped.InstanceTrace.new_batch(items)):
        _same_pedersen_trace(got, want)
    _same_pedersen_trace(pedersen.dummy_instance_trace(9),
                         jax_ped.dummy_instance_trace(9))
    for which in (0, 1):
        assert pedersen.periodic_table_points(which) == \
            jax_ped.periodic_table_points(which)


def test_bitwise_builtin_matches_jax():
    from sandstorm_tpu.builtins import bitwise as jax_bw
    from sandstorm_tpu_torch.builtins import bitwise
    rng = np.random.default_rng(17)
    for i in range(4):
        x, y = _ints(rng, 2, 1 << 251)
        assert bitwise.InstanceTrace.new(i, x, y).__dict__ == \
            jax_bw.InstanceTrace.new(i, x, y).__dict__


def test_small_trace_dies_with_the_diluted_diagnostic():
    """At 256 cycles the diluted pool's padding does not fit the trace: the
    port dies with the JAX package's diagnostic
    (tests/test_e2e_plain.py pins it there)."""
    claim, witness = recursive_loop_claim(256, CPU, pedersen=0, bitwise=0)
    with pytest.raises(AssertionError, match="diluted padding overflow"):
        claim.generate_trace(witness)


@pytest.mark.parametrize("field", ["goldilocks", "gl3"])
def test_recursive_layout_takes_the_252_bit_field_only(stand_in, field):
    from sandstorm_tpu_torch.binary.formats import Layout
    from sandstorm_tpu_torch.claims import CairoClaim
    from sandstorm_tpu_torch.fields.gl3 import GL3
    from sandstorm_tpu_torch.fields.goldilocks import GL
    pub = stand_in[0].public_input
    with pytest.raises(NotImplementedError):
        CairoClaim(None, pub, device=CPU, layout=Layout.RECURSIVE,
                   field=GL if field == "goldilocks" else GL3,
                   scheme="generic")
