"""The DEEP composition's plain version (stark/prover.py _deep_compose, the
windowed loop on CPU tensors: what deep_compose runs for a CPU tensor)
against the JAX package's _deep_compose, on seeded LDE columns with the
recursive (73 points) and starknet (192 points) trace arguments at
N = 2^10, on the CPU.

Inputs are made with numpy from a seed and handed to both packages through
sandstorm_tpu_torch.interop.  Tolerance 0: the arithmetic is exact.  The
kernel's fraction form (csrc/deep.cu: one num / den a row, one batch
inversion) lives only on the card: chip_smoke.py holds it to this plain
version at the recursive and starknet paths' shapes, and
tests/test_torch_cuda.py at small ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sandstorm_tpu.fields.fp252 import Fp252 as JF
from sandstorm_tpu.stark import prover as jprover
from sandstorm_tpu_torch.air.expr import trace_arguments
from sandstorm_tpu_torch.fields.fp252 import Fp252 as TF
from sandstorm_tpu_torch.interop import to_jax_digits
from sandstorm_tpu_torch.stark import prover

P = TF.MODULUS
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ints(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % P
            for _ in range(count)]


@pytest.mark.parametrize("layout", ["recursive", "starknet"])
def test_plain_deep_matches_jax(layout):
    if layout == "recursive":
        from sandstorm_tpu_torch.layouts.recursive.air import \
            RecursiveAirConfig as A
        n_air, K = 1 << 12, 73
    else:
        from sandstorm_tpu_torch.layouts.starknet.air import \
            StarknetAirConfig as A
        n_air, K = 1 << 15, 192
    targs = trace_arguments(A.constraints(n_air, P,
                                          TF.root_of_unity_int(n_air)))
    rng = np.random.default_rng(40 + K)
    n, blowup = 1 << 9, 2
    N = n * blowup
    ncols = 1 + max(c for c, _ in targs)
    cols = {c: _ints(rng, N) for c in range(ncols)}
    comp = [_ints(rng, N) for _ in range(2)]
    tvals, cvals = _ints(rng, len(targs)), _ints(rng, 2)
    z, alpha = _ints(rng, 2)
    g = TF.root_of_unity_int(n)
    dom = prover._DomainCache(TF, N, TF.GENERATOR, CPU)
    got = prover.deep_compose(
        TF, dom, targs, {c: TF.encode_ints(v, CPU) for c, v in cols.items()},
        [TF.encode_ints(v, CPU) for v in comp], tvals, cvals, z, g, n, alpha)
    assert prover.LAST_CHUNKS["DEEP composition"] == 1
    jdom = jprover._DomainCache(JF, N, JF.GENERATOR)
    want = jprover._deep_compose(
        JF, jdom, targs, {c: JF.encode_ints(v) for c, v in cols.items()},
        [JF.encode_ints(v) for v in comp], tvals, cvals, z, g, n, alpha)
    assert len({off for _, off in targs}) + 1 == K
    assert got.shape == (N, 8)
    assert np.array_equal(to_jax_digits(got), np.asarray(jnp.asarray(want)))
