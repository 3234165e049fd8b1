"""The eth scheme's hashing on the CPU against the JAX package: the plain
twin of the Keccak kernel (sandstorm_tpu_torch/hashing/keccak.py) against
JAX keccak256_words, the host keccak256 against its KATs, the masked Keccak
tree (merkle.MaskedKeccakMerkleTree) and the host LeafVariant tree against
the JAX package's, and the PoW grind (crypto/grind.py) against the JAX
grind and the host loop.  Inputs come from numpy seeds; tolerance 0 (hashes
and nonces are exact)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sandstorm_tpu_torch.crypto.hashes import (P, MaskedKeccak256HashFn,
                                               blake2s256, keccak256,
                                               to_montgomery_bytes)
from sandstorm_tpu_torch.hashing.keccak import (keccak256_words,
                                                keccak256_words_plain)

CPU = torch.device("cpu")


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


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("W", [1, 8, 16, 33, 34, 35, 40, 64])
def test_plain_twin_matches_jax_keccak256_words(W):
    """257 rows of W words: one, two and three permutations around the
    136-byte rate (W = 33, 34, 35), base rows (40), FRI rows (64)."""
    from sandstorm_tpu.hashing.keccak import keccak256_words as jax_keccak
    msg = _words(np.random.default_rng(W), (257, W))
    got = keccak256_words(torch.from_numpy(msg.view(np.int32)))
    want = np.asarray(jax_keccak(jnp.asarray(msg)))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_host_keccak256_kats_and_plain_twin():
    """The KATs of tests/test_crypto.py, and the plain twin on whole-word
    messages of 0, 4 and 200 bytes against the host hash."""
    assert keccak256(b"").hex() == \
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert keccak256(b"abc").hex() == \
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    for data in (b"", b"abcd", b"a" * 200):
        msg = np.frombuffer(data, "<u4").reshape(1, -1).view(np.int32)
        got = keccak256_words_plain(torch.from_numpy(msg.copy()))
        assert got.numpy().view("<u4").tobytes() == keccak256(data)


def test_masked_digests_keep_opposite_ends():
    """MaskedKeccak256<20> keeps the first 20 digest bytes (LE words 0..4,
    keep_words = 5); MaskedBlake2s<20> keeps the last 20."""
    from sandstorm_tpu_torch.crypto.hashes import MaskedBlake2sHashFn
    data = bytes(range(64))
    assert MaskedKeccak256HashFn(20).hash(data) == \
        keccak256(data)[:20] + bytes(12)
    assert MaskedBlake2sHashFn(20).hash(data) == \
        bytes(12) + blake2s256(data)[12:]
    msg = torch.from_numpy(np.frombuffer(data, "<u4").view(np.int32)
                           .reshape(1, 16).copy())
    assert keccak256_words(msg, keep_words=5).numpy().view("<u4").tobytes() \
        == MaskedKeccak256HashFn(20).hash(data)


def _felt_columns(ncols, n, seed):
    """ncols columns of n random felts (< p) with 0, 1 and p - 1 among
    them: (the felts as python ints, their Montgomery big-endian words as
    [n, 8] uint32 arrays)."""
    rng = np.random.default_rng(seed)
    cols = []
    for c in range(ncols):
        vals = [int.from_bytes(rng.bytes(32), "big") % P for _ in range(n)]
        vals[c % n], vals[(c + 1) % n], vals[(c + 2) % n] = 0, 1, P - 1
        cols.append(vals)
    words = [np.stack([np.frombuffer(to_montgomery_bytes(v), "<u4")
                       for v in vals]) for vals in cols]
    return cols, words


@pytest.mark.parametrize("ncols", [1, 5, 8])
def test_masked_keccak_tree_matches_jax(ncols):
    """Root and every query path of the port's tree (levels on the CPU
    twin) equal the JAX package's MaskedKeccakMerkleTree at 2^8 rows, and
    the host LeafVariant tree (both packages') has the same root and
    paths; a single-column tree's leaves are the raw Montgomery felts."""
    from sandstorm_tpu.crypto.hashes import MaskedKeccak256HashFn as JaxH
    from sandstorm_tpu.crypto.merkle_variants import \
        LeafVariantMerkleTree as JaxLeafVariant
    from sandstorm_tpu.merkle import MaskedKeccakMerkleTree as JaxTree
    from sandstorm_tpu_torch.crypto.merkle_variants import \
        LeafVariantMerkleTree
    from sandstorm_tpu_torch.merkle import MaskedKeccakMerkleTree
    n = 1 << 8
    cols, words = _felt_columns(ncols, n, 100 + ncols)
    tree = MaskedKeccakMerkleTree.from_mont_word_columns(
        [torch.from_numpy(w.view(np.int32)) for w in words])
    ref = JaxTree.from_mont_word_columns([jnp.asarray(w) for w in words])
    assert tree.single_col == (ncols == 1)
    assert tree.root == ref.root
    idx = list(range(n))
    paths = tree.prove_batch(idx)
    assert paths == ref.prove_batch(idx)

    rows = [[c[i] for c in cols] for i in range(n)]
    H = MaskedKeccak256HashFn(20)
    host = LeafVariantMerkleTree.from_rows(H, rows)
    jhost = JaxLeafVariant.from_rows(JaxH(20), rows)
    enc = (lambda x: to_montgomery_bytes(x) if isinstance(x, int) else x)
    assert host.root == jhost.root == tree.root
    for i in (0, 1, 77, n - 1):
        assert [enc(x) for x in host.prove(i)] == paths[i]
        assert host.prove(i) == jhost.prove(i)
        assert LeafVariantMerkleTree.verify_row(H, tree.root, i, rows[i],
                                                paths[i])
        assert JaxLeafVariant.verify_row(JaxH(20), tree.root, i, rows[i],
                                         paths[i])
        assert not LeafVariantMerkleTree.verify_row(
            H, tree.root, i ^ 1, rows[i], paths[i])


def test_single_column_conventions_match_jax():
    """A one-column tree: the device leaf level holds the Montgomery
    big-endian felt, hash_row gives the canonical big-endian felt (what the
    prover writes as the view's sibling_leaf), and verify_row re-encodes an
    int leaf in Montgomery form; each as the JAX scheme has it."""
    from sandstorm_tpu.fields.fp252 import Fp252 as JF
    from sandstorm_tpu.stark.scheme import get_scheme as jax_scheme
    from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
    from sandstorm_tpu_torch.stark.scheme import get_scheme
    cols, _ = _felt_columns(1, 16, 7)
    col = TF.encode_ints(cols[0], CPU)
    scheme, ref = get_scheme("eth"), jax_scheme("eth")
    tree = scheme.commit(TF, [col])
    jtree = ref.commit(JF, [JF.encode_ints(cols[0])])
    assert tree.root == jtree.root
    paths = tree.prove_batch(range(16))
    assert paths == jtree.prove_batch(list(range(16)))
    for i in range(16):
        v = cols[0][i]
        assert paths[i ^ 1][0] == to_montgomery_bytes(v)
        assert scheme.hash_row(TF, [v]) == ref.hash_row(JF, [v]) == \
            v.to_bytes(32, "big")
        assert scheme.verify_row(TF, tree.root, i, [v], paths[i])
        assert ref.verify_row(JF, tree.root, i, [v], paths[i])


def _host_grind(H, prefix, bits, start):
    nonce = start
    while int.from_bytes(H(prefix + nonce.to_bytes(8, "big"))[:4],
                         "big") >> (32 - bits):
        nonce += 1
    return nonce


@pytest.mark.parametrize("hash_name", ["keccak", "blake2s"])
def test_grind_matches_jax_and_host_loop(hash_name):
    """The smallest valid nonce from `start`, on the CPU twin, equals the
    JAX grind's and the host loop's at 4, 8 and 12 bits from 0, 1 and
    65535 (the last batch edge of the first batch)."""
    from sandstorm_tpu.crypto.grind import grind as jax_grind
    from sandstorm_tpu_torch.crypto.grind import grind
    H = keccak256 if hash_name == "keccak" else blake2s256
    rng = np.random.default_rng(5)
    for bits in (4, 8, 12):
        prefix = rng.bytes(32)
        for start in (0, 1, 65535):
            got = grind(hash_name, prefix, bits, start, device=CPU)
            assert got == jax_grind(hash_name, prefix, bits, start)
            assert got == _host_grind(H, prefix, bits, start)


def test_grind_refuses_what_the_kernel_does_not_take():
    from sandstorm_tpu_torch.crypto.grind import grind
    for args in (("keccak", bytes(31), 8), ("keccak", bytes(32), 0),
                 ("keccak", bytes(32), 33), ("sha256", bytes(32), 8)):
        with pytest.raises(ValueError):
            grind(*args, device=CPU)
