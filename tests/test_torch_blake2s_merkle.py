"""The port's Blake2s and Merkle tree against hashlib and the JAX package
(sandstorm_tpu.hashing.blake2s, sandstorm_tpu.merkle), on the CPU."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.hashing.blake2s import hash_node_pairs as jax_nodes
from sandstorm_tpu.hashing.blake2s import hash_rows as jax_rows
from sandstorm_tpu.merkle import MerkleTree as JaxTree
from sandstorm_tpu_torch.hashing.blake2s import (blake2s_words,
                                                 hash_node_pairs, hash_rows)
from sandstorm_tpu_torch.merkle import FetchPlan, MerkleTree


def _words(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


@pytest.mark.parametrize("W,nbytes", [(40, 160), (16, 64), (16, 63), (3, 9),
                                      (17, 65), (1, 0)])
def test_blake2s_matches_hashlib(W, nbytes):
    msg = _words(W, (9, W))
    got = blake2s_words(torch.from_numpy(msg.view(np.int32)), nbytes)
    for r in range(9):
        want = hashlib.blake2s(msg[r].astype("<u4").tobytes()[:nbytes],
                               digest_size=32).digest()
        assert got[r].numpy().view("<u4").tobytes() == want


def test_rows_and_nodes_match_jax():
    cols = [_words(10 + c, (32, 8)) for c in range(5)]
    got = hash_rows([torch.from_numpy(c.view(np.int32)) for c in cols])
    want = jax_rows([jnp.asarray(c) for c in cols])
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    got_nodes = hash_node_pairs(got)
    assert np.array_equal(got_nodes.numpy().view(np.uint32),
                          np.asarray(jax_nodes(want)))


def test_merkle_root_and_paths_match_jax():
    cols = [_words(20 + c, (64, 8)) for c in range(3)]
    tree = MerkleTree.from_matrix_columns(
        [torch.from_numpy(c.view(np.int32)) for c in cols])
    ref = JaxTree.from_matrix_columns([jnp.asarray(c) for c in cols])
    assert tree.root == ref.root
    idx = [0, 5, 33, 63]
    paths = tree.prove_batch(idx)
    assert paths == ref.prove_batch(idx)
    for q, path in zip(idx, paths):
        row = b"".join(c[q].astype("<u4").tobytes() for c in cols)
        assert MerkleTree.verify(tree.root, q, MerkleTree.hash_row_host(row),
                                 path)
        assert not MerkleTree.verify(tree.root, q ^ 1,
                                     MerkleTree.hash_row_host(row), path)


def test_fetch_plan_one_copy_per_plan():
    plan = FetchPlan()
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    b = torch.tensor([-1], dtype=torch.int32)
    ha, hb = plan.add(a), plan.add(b)
    res = plan.run()
    assert np.array_equal(res[ha], a.numpy())
    assert res[hb].tolist() == [0xFFFFFFFF]
