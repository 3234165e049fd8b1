"""The port's Pedersen hashing and friendly Merkle tree against the JAX
package and python-int oracles, on the CPU (the plain versions of the
ec_madd_walk kernel).  Every comparison is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu_torch import merkle as port_merkle
from sandstorm_tpu_torch import native
from sandstorm_tpu_torch.builtins.curve import P, ec_add, ec_mul
from sandstorm_tpu_torch.builtins.pedersen import (P1, P2, P3, P4,
                                                   pedersen_hash_oracle,
                                                   shift_and_table_points)
from sandstorm_tpu_torch.fields import fp252_cuda as fc
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.hashing import pedersen
from sandstorm_tpu_torch.interop import from_jax_digits, to_jax_digits

CPU = torch.device("cpu")
# edge inputs: zeros, a high window (bit 248), p - 1, masked-digest sizes
EDGE_A = [0, 0, 1, P - 1, (1 << 160) - 1, 12345]
EDGE_B = [0, (1 << 248) + 5, 0, P - 1, (1 << 159) + 3, (1 << 251)]


def _canon(vals):
    """python ints -> canonical [n, 8] int32 limbs."""
    return torch.from_numpy(np.stack(
        [native._int_to_limbs(v) for v in vals]).view(np.int32).copy())


def _ints(t):
    return [int.from_bytes(r.tobytes(), "little")
            for r in t.numpy().view("<u8").reshape(-1, 4)]


def test_host_batch_matches_oracle_and_jax():
    from sandstorm_tpu import native as jax_native
    rng = random.Random(1)
    av = EDGE_A + [rng.getrandbits(251) for _ in range(6)]
    bv = EDGE_B + [rng.getrandbits(160) for _ in range(6)]
    got = native.pedersen_hash_pairs_ints(av, bv)
    assert got == jax_native.pedersen_hash_pairs_ints(av, bv)
    assert got == [pedersen_hash_oracle(a, b) for a, b in zip(av, bv)]
    # the tables themselves equal the JAX package's
    t, s = native._window_tables()
    jt, js = jax_native._window_tables()
    assert np.array_equal(t, jt) and np.array_equal(s, js)


def _jacobian(pt, z):
    """Affine python point -> Montgomery (X, Y, Z) ints with Z = z."""
    x, y = pt
    return x * z * z % P, y * z * z * z % P, z


def test_ec_madd_plain_matches_affine_add():
    rng = random.Random(2)
    n = 12
    acc = [ec_mul(rng.getrandbits(64) + 1, P1) for _ in range(n)]
    add = [ec_mul(rng.getrandbits(64) + 1, P3) for _ in range(n)]
    zs = [rng.randrange(1, P) for _ in range(n)]
    jac = [_jacobian(p, z) for p, z in zip(acc, zs)]
    X, Y, Z = (TF.encode_ints([j[k] for j in jac], CPU) for k in range(3))
    x2 = TF.encode_ints([q[0] for q in add], CPU)
    y2 = TF.encode_ints([q[1] for q in add], CPU)
    skip = torch.tensor([i % 3 == 0 for i in range(n)])
    X3, Y3, Z3 = fc.ec_madd_plain(X, Y, Z, x2, y2, skip)
    for i, (x, y, z) in enumerate(zip(*(TF.decode_ints(t)
                                        for t in (X3, Y3, Z3)))):
        if skip[i]:
            assert (x, y, z) == jac[i]
            continue
        zi = pow(z, -1, P)
        assert (x * zi * zi % P, y * zi * zi * zi % P) == \
            ec_add(acc[i], add[i])


def test_walk_8bit_matches_jax_and_native():
    """ec_madd_walk_plain at 8-bit windows plus the affine finish
    (hash_pairs on a CPU tensor) against the JAX 8-bit XLA walk and the
    native batch."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.hashing.pedersen_tpu import (_hash_pairs_core,
                                                    _tables_dev)
    rng = random.Random(3)
    av = EDGE_A[:4] + [rng.getrandbits(251) for _ in range(4)]
    bv = EDGE_B[:4] + [rng.getrandbits(160) for _ in range(4)]
    a, b = _canon(av), _canon(bv)
    native.HASHES.clear()
    got = pedersen.hash_pairs(TF, a, b)
    assert native.HASHES["cpu"] == len(av)
    t, s = _tables_dev()
    want = _hash_pairs_core(JF, jnp.asarray(to_jax_digits(a)),
                            jnp.asarray(to_jax_digits(b)), t, s)
    assert np.array_equal(to_jax_digits(got), np.asarray(want))
    assert _ints(got) == native.pedersen_hash_pairs_ints(av, bv)


def _window16_point(k, v):
    """Affine python point that 16-bit window k (0..31) adds for value v."""
    lo, hi = ((P1, P2), (P3, P4))[k // 16]
    k %= 16
    if k < 15:
        return ec_mul(v << (16 * k), lo)
    return ec_add(ec_mul((v & 0xFF) << 240, lo), ec_mul(v >> 8, hi))


def test_walk_16bit_plain_matches_oracle():
    """The 16-bit window order of the walk (digit k of a drives window k,
    digit k of b window 16 + k) on a table that holds only the entries the
    inputs read, against the python oracle."""
    rng = random.Random(4)
    av = [0, rng.getrandbits(251), P - 1]
    bv = [(1 << 248) + 5, rng.getrandbits(160), 7]
    a, b = _canon(av), _canon(bv)
    table = torch.zeros((32, 65536, 16), dtype=torch.int32)
    v = torch.cat([fc.window_values(a, 16), fc.window_values(b, 16)], 1)
    for k in range(32):
        for val in sorted(set(v[:, k].tolist()) - {0}):
            x, y = _window16_point(k, val)
            table[k, val] = TF.encode_ints([x, y], CPU).reshape(16)
    X, _, Z = fc.ec_madd_walk(a, b, table, pedersen.shift_point(CPU), 16)
    xs, zs = TF.decode_ints(X), TF.decode_ints(Z)
    got = [x * pow(z, -2, P) % P for x, z in zip(xs, zs)]
    assert got == [pedersen_hash_oracle(x, y) for x, y in zip(av, bv)]


def test_combine_window_matches_affine_sums():
    """The 16-bit table build for one window (k = 15: the low byte rides
    2^240 P1, the high byte P2) at sampled entries, zero bytes included."""
    t8 = pedersen.tables8(CPU)
    k = 15
    got = pedersen.combine_windows(TF, t8[2 * k:2 * k + 1],
                                   t8[2 * k + 1:2 * k + 2])[0]
    assert got.shape == (65536, 16)
    rng = random.Random(5)
    vals = [0, 1, 0xFF, 0x100, 0x101, 0x1200, 0xFF00, 0xFFFF, 0x0800] + [
        rng.randrange(1, 65536) for _ in range(11)]
    for v in vals:
        if v == 0:
            assert not got[v].any()
            continue
        x, y = TF.decode_ints(got[v].reshape(2, 8))
        assert (x, y) == _window16_point(k, v), hex(v)


def test_byte_orders_match_jax():
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.hashing.pedersen_tpu import digest_words_to_digits
    rng = np.random.default_rng(6)
    vals = [int(x) for x in rng.integers(0, 1 << 62, size=16)] + [0, P - 1]
    mont = TF.encode_ints(vals, CPU)
    want = np.asarray(JF.to_mont_be_words(jnp.asarray(to_jax_digits(mont))))
    assert np.array_equal(TF.to_mont_be_words(mont).numpy().view(np.uint32),
                          want)
    words = rng.integers(0, 1 << 32, size=(16, 8), dtype=np.uint64) \
        .astype(np.uint32)
    want = np.asarray(digest_words_to_digits(jnp.asarray(words)))
    got = pedersen.digest_words_to_canon(torch.from_numpy(words.view(np.int32)))
    assert np.array_equal(to_jax_digits(got), want)
    # and the JAX digits read back to the same port limbs
    assert torch.equal(from_jax_digits(want), got)


def _wire(node):
    kind, v = node
    return v if isinstance(v, bytes) else int(v).to_bytes(32, "big")


@pytest.mark.parametrize("ncols,n,n_friendly", [(3, 64, 22), (3, 64, 3),
                                                (1, 32, 22)])
def test_friendly_tree_matches_host(monkeypatch, ncols, n, n_friendly):
    """FriendlyMerkleTreeFast with the device-level threshold lowered to 4
    pairs, so that the plain walk hashes the big levels, against the JAX
    package's host FriendlyMerkleTree (and the port's copy of it); with
    n_friendly = 3 the Blake merges below depth 3 run too."""
    from sandstorm_tpu.crypto.merkle_variants import FriendlyMerkleTree as JT
    from sandstorm_tpu_torch.crypto.merkle_variants import FriendlyMerkleTree
    monkeypatch.setattr(port_merkle, "DEVICE_PEDERSEN_MIN_PAIRS", 4)
    rng = random.Random(7 + ncols + n_friendly)
    vals = [[rng.getrandbits(251) for _ in range(n)] for _ in range(ncols)]
    cols = [TF.encode_ints(v, CPU) for v in vals]
    rows = [list(r) for r in zip(*vals)]
    if ncols == 1:
        tree = port_merkle.FriendlyMerkleTreeFast.from_canonical_column(
            TF, TF.from_mont(cols[0]))
    else:
        tree = port_merkle.FriendlyMerkleTreeFast.from_mont_word_columns(
            TF, [TF.to_mont_be_words(c) for c in cols], n_friendly)
    assert len(tree._felt_dev) > 1, "the plain walk was not taken"
    ref = JT.from_rows(n_friendly, rows)
    assert FriendlyMerkleTree.from_rows(n_friendly, rows).levels == ref.levels
    assert tree.root == _wire(ref.root)
    idx = [0, 1, 7, n - 1]
    assert tree.prove_batch(idx) == [[_wire(x) for x in ref.prove(i)]
                                     for i in idx]


def test_cairo_coin_matches_reference_vector():
    """The reference's own reseed vector (crypto/src/public_coin/cairo.rs),
    as tests/test_crypto.py holds the JAX coin to it, plus draws, queries
    and the PoW grind against the JAX coin."""
    from sandstorm_tpu.crypto.coins import CairoVerifierPublicCoin as JC
    from sandstorm_tpu_torch.crypto.coins import CairoVerifierPublicCoin
    seed = bytes([
        0x1f, 0x9c, 0x7b, 0xc9, 0xad, 0x41, 0xb8, 0xa6, 0x92, 0x36, 0x00,
        0x6e, 0x7e, 0xea, 0x80, 0x38, 0xae, 0xa4, 0x32, 0x96, 0x07, 0x41,
        0xb8, 0x19, 0x79, 0x16, 0x36, 0xf8, 0x2c, 0xc2, 0xd2, 0x5d])
    coin, ref = CairoVerifierPublicCoin(seed), JC(seed)
    for c in (coin, ref):
        c.reseed_with_bytes((941210603170996043151108091873286171552595656949)
                            .to_bytes(32, "big"))
    assert coin.digest == bytes([
        0x60, 0x57, 0x79, 0xf6, 0xc9, 0xae, 0x87, 0x1e, 0xd7, 0x30, 0x56,
        0xb4, 0xeb, 0xaa, 0x61, 0xa7, 0x7e, 0x7f, 0xb5, 0x09, 0xbc, 0x08,
        0xc1, 0x93, 0xf1, 0x3a, 0xdc, 0xbf, 0x0c, 0x0b, 0xed, 0xc0])
    for c in (coin, ref):
        c.reseed_with_field_element_vector(P, [3, 1 << 200, P - 1])
    assert coin.digest == ref.digest
    assert coin.draw_felts(P, 3) == ref.draw_felts(P, 3)
    assert coin.draw_queries(7, 1 << 12) == ref.draw_queries(7, 1 << 12)
    nonce = coin.grind_proof_of_work(8, CPU)
    assert nonce >= 1 and coin.verify_proof_of_work(nonce, 8)
    assert all(not coin.verify_proof_of_work(k, 8) for k in range(1, nonce))


def test_shift_point_is_p0():
    x, y = TF.decode_ints(pedersen.shift_point(CPU).reshape(2, 8))
    assert (x, y) == shift_and_table_points()[0]
