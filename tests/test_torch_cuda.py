"""The port's redesigned kernels against their plain versions on a CUDA
card, away from the main path's shapes: every leaf length, ragged batches,
four-step widths that no tile of adjacent transforms divides, pair lists
that split into several groups.  chip_smoke.py holds the same kernels to
their plain versions at the main path's shapes.

These tests need a card and nvcc: each is marked `cuda` and skips where
torch finds no CUDA device.  The file imports nothing of JAX, so on a
machine without it run

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py sets up the JAX package's CPU backend).  Tolerance 0:
the arithmetic is exact.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sandstorm_tpu_torch.fields import fp252_cuda, gl_cuda  # noqa: E402
from sandstorm_tpu_torch.fields.fp252 import Fp252  # noqa: E402
from sandstorm_tpu_torch.fields.goldilocks import GL  # noqa: E402
from sandstorm_tpu_torch.ntt import ntt_cuda  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


def _rand_gl(rng, shape, dev):
    w = rng.integers(0, 1 << 32, size=tuple(shape) + (2,), dtype=np.uint64)
    w[..., 1] %= 0xFFFFFFFF                   # canonical: hi word < 2^32 - 1
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


def _rand_fp(rng, shape, dev):
    w = rng.integers(0, 1 << 32, size=tuple(shape) + (8,), dtype=np.uint64)
    w[..., 7] &= (1 << 27) - 1
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32, 128, 512, 1024, 2048])
def test_gl_ntt_leaf_every_length_and_ragged_batches(dev, M):
    rng = np.random.default_rng(M)
    for B in (1, 3, 5, 17, 130, 1000):
        for inverse in (False, True):
            x = _rand_gl(rng, (M, B), dev)
            tw = ntt_cuda.stage_table(GL, M, inverse, dev)
            assert torch.equal(
                ntt_cuda.gl_ntt_leaf(x, tw),
                ntt_cuda.ntt_leaf_plain(x, tw, gl_cuda.PLAIN)), (M, B)


@pytest.mark.parametrize("M,C,Bi", [(16, 8, 1), (64, 7, 3), (32, 9, 5),
                                    (256, 5, 15), (2048, 3, 15), (8, 3, 2),
                                    (1024, 16, 1), (2, 5, 3)])
def test_gl_ntt_leaf_fused_widths_no_tile_divides(dev, M, C, Bi):
    rng = np.random.default_rng(M + C + Bi)
    x = _rand_gl(rng, (M, C * Bi), dev)
    tw = ntt_cuda.stage_table(GL, M, False, dev)
    rc = _rand_gl(rng, (M, C, 1), dev)
    assert torch.equal(ntt_cuda.gl_ntt_leaf_fused(x, tw, rc, Bi),
                       ntt_cuda.gl_ntt_leaf_fused_plain(x, tw, rc, Bi))


def test_gl_leaves_refuse_what_the_kernel_does_not_take(dev):
    x = _rand_gl(np.random.default_rng(0), (4096, 2), dev)
    with pytest.raises(ValueError, match="bad shape"):
        ntt_cuda.gl_ntt_leaf(x, ntt_cuda.stage_table(GL, 4096, False, dev))
    tw = ntt_cuda.stage_table(GL, 16, False, dev)
    with pytest.raises(ValueError, match="bad twiddles"):
        ntt_cuda.gl_ntt_leaf_fused(x[:16].contiguous(), tw,
                                   x[:16, :1].reshape(16, 1, 1, 2), 3)


@pytest.mark.parametrize("pairs", [
    [(0, 0)],
    [(2, 5), (0, 1), (2, 0), (1, 1), (0, 5), (2, 5)],
    [(1, c) for c in range(11)] + [(0, 3)],
    [(k, 4) for k in range(3)],
    [(k, c) for c in range(11) for k in range(3)],
    # starknet's shape: 192 points, most naming one or two columns, 192
    # groups (the recursive path's pair list makes 81)
    [(k, (7 * k) % 11) for k in range(192)]
    + [(k, (7 * k + 3) % 11) for k in range(0, 192, 12)],
], ids=["one_pair", "unsorted_repeated", "wide_point", "column_at_every_point",
        "dense", "starknet_groups"])
def test_open_pairs_groups_and_ranges(dev, pairs):
    from sandstorm_tpu_torch.stark.openings import point_powers
    rng = np.random.default_rng(len(pairs))
    prng = random.Random(len(pairs))
    n, C, b = 4096, 11, 64
    K = max(3, 1 + max(k for k, _ in pairs))
    kidx, cidx = [k for k, _ in pairs], [c for _, c in pairs]
    if K > 3:
        assert fp252_cuda.pair_groups(kidx, cidx).shape[0] > 81
    P = Fp252.MODULUS
    pts = [prng.randrange(P) for _ in range(K)]
    lo = point_powers(Fp252, pts, b, dev)
    hi = point_powers(Fp252, [pow(z, b, P) for z in pts], n // b, dev)
    cols = _rand_fp(rng, (C, n), dev)
    assert torch.equal(fp252_cuda.open_pairs(cols, lo, hi, kidx, cidx),
                       fp252_cuda.open_pairs_plain(cols, lo, hi, kidx, cidx))


def _rand_words(rng, shape, dev):
    return torch.from_numpy(rng.integers(0, 1 << 32, size=shape,
                                         dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)


@pytest.mark.parametrize("W", [0, 1, 16, 33, 34, 35, 40, 56, 64, 67, 68, 69,
                               72])
def test_keccak_rows_rate_boundary_and_masks(dev, W):
    """keccak_rows against its plain twin on the card at every word count
    around the 136-byte rate (one, two and three permutations), ragged row
    counts and the three masks, and at starknet's 9-felt rows (72 words);
    a few rows against the host keccak256."""
    from sandstorm_tpu_torch.crypto.hashes import keccak256
    from sandstorm_tpu_torch.hashing import keccak
    rng = np.random.default_rng(W)
    for n in (1, 129, 1000):
        msg = _rand_words(rng, (n, W), dev)
        for keep in (8, 5, 0):
            got = keccak.keccak256_words(msg, keep_words=keep)
            assert torch.equal(got, keccak.keccak256_words_plain(msg, keep))
        host = msg[:5].cpu().numpy().view(np.uint32)
        dig = keccak.keccak256_words(msg[:5]).cpu().numpy().view(np.uint32)
        for r in range(min(n, 5)):
            assert dig[r].astype("<u4").tobytes() == keccak256(
                host[r].astype("<u4").tobytes())


@pytest.mark.parametrize("hash_name", ["keccak", "blake2s"])
def test_pow_grind_returns_the_smallest_hit(dev, hash_name):
    """One batch: the kernel's offset equals the plain twin's first hit on
    the card, the same in every repeat (atomicMin, whatever the block
    order), and no earlier nonce passes on the host; a batch with no hit
    gives BATCH; a grind over several batches equals the twin's."""
    from sandstorm_tpu_torch.crypto import grind as g
    from sandstorm_tpu_torch.crypto.hashes import blake2s256, keccak256
    H = keccak256 if hash_name == "keccak" else blake2s256
    rng = np.random.default_rng(3)
    for bits in (4, 8, 12):
        prefix = rng.bytes(32)
        words = torch.from_numpy(np.frombuffer(prefix, "<u4").view(np.int32)
                                 .copy()).to(dev)
        for nonce0 in (0, 1, 65535, (1 << 40) + 7):
            got = {g.pow_grind(words, nonce0, bits, hash_name)
                   for _ in range(5)}
            assert got == {g.pow_grind_plain(words, nonce0, bits, hash_name)}
            idx = got.pop()
            if idx < g.BATCH and idx < 300:
                for k in range(idx + 1):
                    h = H(prefix + (nonce0 + k).to_bytes(8, "big"))
                    lead = int.from_bytes(h[:4], "big")
                    assert (lead < 1 << (32 - bits)) == (k == idx)
    # no hit at 32 bits in this batch (one in 2^16 batches has one)
    assert g.pow_grind(words, 0, 32, hash_name) == g.pow_grind_plain(
        words, 0, 32, hash_name)
    start = 5
    nonce = g.grind(hash_name, prefix, 18, start, device=dev)
    n0 = start
    while True:
        idx = g.pow_grind_plain(words, n0, 18, hash_name)
        if idx < g.BATCH:
            assert nonce == n0 + idx
            break
        n0 += g.BATCH
